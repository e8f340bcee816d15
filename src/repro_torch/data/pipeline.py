"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

Batch ``step`` is a pure function of ``(seed, step)``, drawn with the
port's threefry (``core/prng.py``), so it is the reference's batch.
Determinism is the fault-tolerance contract: an elastic restart replays
the exact batch sequence with no data-loader state to checkpoint.

The LM token stream (``lm_batch``): a simple evolving-ngram language, next
token ``(31 * prev + 17) % V`` unless a 10% noise draw puts a random token
there, so that tiny models actually learn; bit-equal to the reference's.
The satellite pose task, random poses rendered as keypoint-blob images with
the UrsoNet geometry (the paper's Table I workload).  The poses' ``loc``
comes from uniforms only and equals the reference's bit for bit; ``quat``
goes through ``normal`` (about 1% of draws within 3 ulps, see ``prng``)
and its norm, and the images through ``exp`` and two small einsums, whose
float32 results may differ from XLA's by a few ulps.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import prng
from repro_torch.core.tree import tree_map


# ---------------------------------------------------------------------------
# LM tokens
# ---------------------------------------------------------------------------
def _affine_powers(n: int, vocab: int) -> Tuple[list, list]:
    """``(A, B)`` with ``f^k(x) = (A[k] * x + B[k]) % vocab`` for the
    stream's step ``f(x) = (31 * x + 17) % vocab``, k = 0 .. n-1."""
    a, b = [1], [0]
    for _ in range(n - 1):
        a.append(a[-1] * 31 % vocab)
        b.append((b[-1] * 31 + 17) % vocab)
    return a, b


def lm_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, seed: int = 0,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Markov-ish token stream: next token = (a*prev + b) % V with noise.
    Returns int32 ``tokens`` and ``labels`` [B, S] on ``device`` (labels
    are the tokens shifted left by one, wrapping).

    The reference scans the recurrence token by token; here each token is
    the step map applied ``k`` times to the last token the noise (or the
    first draw) set, ``k`` positions back, with the map's powers tabled:
    the same integers, in one pass."""
    key = prng.fold_in(prng.threefry_seed(
        torch.full((), seed, dtype=torch.int64, device=device)), step)
    b, s, v = shape.global_batch, shape.seq_len, cfg.vocab_size
    k1, k2, k3 = prng.split(key, 3).unbind(0)
    first = prng.randint(k1, (b, 1), 0, v)
    noise = prng.bernoulli(k2, 0.1, (b, s - 1))
    rand = prng.randint(k3, (b, s - 1), 0, v)

    reset = torch.cat([torch.ones_like(first, dtype=torch.bool), noise], 1)
    start = torch.cat([first, rand], 1).long()
    pos = torch.arange(s, device=start.device).expand(b, s)
    last = torch.where(reset, pos, 0).cummax(dim=1).values
    a, c = (torch.tensor(t, dtype=torch.int64, device=start.device)
            for t in _affine_powers(s, v))
    k = pos - last
    tokens = ((a[k] * start.gather(1, last) + c[k]) % v).to(torch.int32)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": tokens, "labels": labels}


def lm_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                   train: bool = True) -> Dict[str, torch.Tensor]:
    """The batch's shapes and dtypes as ``meta`` tensors."""
    tok = lambda: torch.empty((shape.global_batch, shape.seq_len),
                              dtype=torch.int32, device="meta")
    return {"tokens": tok(), "labels": tok()} if train else {"tokens": tok()}


# rigid-body keypoints of a soyuz-ish shape (body frame, meters)
_KEYPOINTS = np.array([
    [0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [-1.5, 0.0, 0.0],
    [0.0, 4.0, 0.0], [0.0, -4.0, 0.0], [0.0, 0.0, 1.2],
    [0.8, 2.0, 0.4], [-0.8, -2.0, -0.4],
], np.float32)
_FOCAL = 600.0
# distinct color signature per keypoint so orientation is recoverable
_KP_COLORS = np.array([
    [1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0],
    [1.0, 1.0, 0.1], [0.1, 1.0, 1.0], [1.0, 0.1, 1.0],
    [0.9, 0.5, 0.1], [0.4, 0.2, 0.9],
], np.float32)


_TABLES: Dict = {}


def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keypoints and their colors on ``device``, copied there once (a
    copy from pageable host memory waits for the stream)."""
    if device not in _TABLES:
        _TABLES[device] = (torch.as_tensor(_KEYPOINTS, device=device),
                           torch.as_tensor(_KP_COLORS, device=device))
    return _TABLES[device]


def _quat_rotate(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)
    return torch.einsum("...ij,kj->...ki", r, pts)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1, keepdims=True)`` as XLA's CPU code sums
    it: one fused multiply-add per element, in order (emulated in
    float64)."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        xi = x[..., i].double()
        acc = (xi * xi + acc).float()
    return torch.sqrt(acc)[..., None]


def pose_batch(batch: int, step: int, seed: int = 0,
               image_hw: Tuple[int, int] = (96, 128),
               device="cuda") -> Dict[str, torch.Tensor]:
    """Random poses -> blob-rendered images on ``device``.  loc in meters
    (depth 8-24 m), orientation unit quaternion — same regime as
    soyuz_easy.  Returns ``images`` [B, H, W, 3], ``loc`` [B, 3] and
    ``quat`` [B, 4], float32."""
    key = prng.fold_in(prng.threefry_seed(
        torch.full((), seed + 7919, dtype=torch.int64, device=device)), step)
    kq, kt = prng.split(key)
    q = prng.normal(kq, (batch, 4))
    q = q / _norm(q)
    q = q * torch.sign(q[:, :1] + 1e-9)                # canonical hemisphere
    loc = torch.stack([
        prng.uniform(kt, (batch,), -3.0, 3.0),
        prng.uniform(prng.fold_in(kt, 1), (batch,), -2.0, 2.0),
        prng.uniform(prng.fold_in(kt, 2), (batch,), 8.0, 24.0),
    ], dim=-1)

    h, w = image_hw
    kp, colors = _tables(torch.device(device))
    pts = _quat_rotate(q, kp) + loc[:, None, :]
    scale = min(h, w) / 960.0
    u = pts[..., 0] / pts[..., 2] * _FOCAL * scale + w / 2
    v = pts[..., 1] / pts[..., 2] * _FOCAL * scale + h / 2
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    # a float over a tensor: a true division (``c / t`` in torch multiplies
    # by the reciprocal)
    near = torch.div(torch.full((), 20.0 * scale * 8.0, device=device),
                     pts[..., 2])
    sig = 2.0 + near                                   # nearer -> bigger blob
    blob = torch.exp(-((yy - v[:, None, None, :]) ** 2
                       + (xx - u[:, None, None, :]) ** 2)
                     / (2 * sig[:, None, None, :] ** 2))
    chan = torch.einsum("bhwk,kc->bhwc", blob, colors)
    images = torch.clamp(chan, 0.0, 1.0)
    return {"images": images, "loc": loc, "quat": q}


class HostShardedStream:
    """Per-host view of the global batch (1000-node data ingestion shape):
    host h of H draws rows [h*B/H, (h+1)*B/H) of the deterministic global
    batch — no coordination, no state."""

    def __init__(self, make_batch, global_batch: int, host_id: int,
                 num_hosts: int):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {num_hosts} hosts")
        self.make_batch = make_batch
        self.lo = host_id * (global_batch // num_hosts)
        self.hi = (host_id + 1) * (global_batch // num_hosts)

    def __call__(self, step: int):
        full = self.make_batch(step)
        return tree_map(lambda a: a[self.lo:self.hi], full)
