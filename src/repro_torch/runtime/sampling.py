"""Per-request sampling knobs (the port of ``repro.runtime.sampling``).

Only greedy decoding is ported: the reference draws sampled tokens from
``jax.random`` threefry keys, and a torch twin of that key stream is a
later slice.  The engine refuses non-greedy requests at ``submit``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (defaults = greedy decode)."""
    temperature: float = 0.0
    top_k: int = 0                    # 0 = full vocabulary
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "SamplingParams":
        return cls(**d)


GREEDY = SamplingParams()
