"""Per-request sampling: greedy / temperature / top-k (the port of
``repro.runtime.sampling``).

Every knob is a per-slot array, so one call samples a whole batch:

* ``temperature`` — 0.0 means greedy (argmax, ties to the lowest index);
* ``top_k`` — 0 means the full vocabulary; otherwise logits below the
  k-th largest are masked to ``-inf`` before the categorical draw;
* ``seed`` + per-token step index — the key for token ``t`` of a request
  is ``fold_in(PRNGKey(seed), t)`` (``core/prng.py``, bit for bit as
  ``jax.random``).  Keys depend only on the request's own seed and its own
  token index, never on the batch, so a sampled request draws the same
  noise solo or packed with strangers.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

import torch

from repro_torch.core import prng


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


def sample_logits(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, seeds: torch.Tensor,
                  steps: torch.Tensor) -> torch.Tensor:
    """Sample one token per row, on the logits' device.

    logits: [B, V]; temps: [B] float32 (<=0 -> greedy); top_ks: [B] int
    (0 -> no truncation); seeds/steps: [B] int -> per-row key
    ``fold_in(PRNGKey(seed), step)``.  Returns [B] int64.
    """
    greedy = torch.argmax(logits, dim=-1)
    l = logits.float()
    v = l.shape[-1]
    # top-k mask: threshold at the k-th largest logit per row
    desc = torch.sort(l, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    truncate = (top_ks[:, None] > 0) & (l < kth)
    scaled = (torch.where(truncate, float("-inf"), l)
              / torch.clamp_min(temps[:, None], 1e-6))
    keys = prng.fold_in(prng.threefry_seed(seeds), steps)
    sampled = prng.categorical(keys, scaled)
    return torch.where(temps > 0.0, sampled, greedy)
