"""Roofline terms of a step on H100 cards (the port of ``repro.roofline``).

Three terms per (arch x shape x mesh), in seconds, each per rank:

    compute    = FLOPs / peak bf16 FLOP/s
    memory     = bytes the GEMMs and kernels read and write / HBM bytes/s
    collective = sum over links of the bytes the rank's collectives put
                 on that link / the link's bytes/s

The dry run (``launch/dryrun.py``) counts the FLOPs and bytes of one traced
step and its collectives; this module holds the card's constants, the
terms, ``model_flops`` (the reference's formula) and ``kernel_work``, the
work of each of the port's hand-written kernels, from which both the dry
run and ``chip_smoke.py``'s ``bound_ms`` take their numbers.

The reference's ``parse_collectives`` and ``_shape_bytes`` read XLA's HLO
text and have no counterpart: the port counts its collectives where it
makes them, by wrapping the ``torch.distributed`` calls of a step.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) measures how much of the
counted compute is useful (remat and replicated compute show as a low
ratio).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), per card
PEAK_BF16 = 989e12          # bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12         # int8 tensor-core OP/s
PEAK_F32 = 67e12            # f32 CUDA-core FLOP/s
HBM_BW = 3.35e12            # HBM3 bytes/s
# NVLink 4: 900 GB/s a card in both directions (same data sheet), 450 each
NVLINK_BW = 450e9
# between nodes: one 400 Gb/s InfiniBand NDR port a card (ConnectX-7)
NETWORK_BW = 400e9 / 8
NODE_CARDS = 8              # cards that NVLink joins: one HGX H100 8-GPU node
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def link_of(ranks: Sequence[int]) -> str:
    """The link a collective over ``ranks`` runs on: NVLink where they lie
    in one node of ``NODE_CARDS`` consecutive ranks, the network
    otherwise."""
    return "nvlink" if len({r // NODE_CARDS for r in ranks}) <= 1 \
        else "network"


def wire_bytes(kind: str, operand_bytes: float, ranks: int) -> float:
    """Bytes one rank sends for a ring ``all-gather`` or ``all-reduce``,
    or an ``all-to-all``, over ``ranks`` ranks, from its operand: an
    all-gather passes the other ranks' parts on, ``(n - 1)`` parts; an
    all-reduce is a reduce-scatter and an all-gather, ``2 (n - 1) / n`` of
    the tensor; an all-to-all sends what is not its own, ``(n - 1) / n``
    of its input as an even one does."""
    if ranks <= 1:
        return 0.0
    if kind == "all-gather":
        return (ranks - 1) * operand_bytes
    if kind == "all-to-all":
        return (ranks - 1) / ranks * operand_bytes
    return 2.0 * (ranks - 1) / ranks * operand_bytes


@dataclass
class RooflineReport:
    """Per-rank quantities (the dry run traces one rank), so the
    reference's global / (chips * peak) formulas reduce to per-rank /
    peak.  ``link_bytes``, where given, holds the bytes the rank's
    collectives put on each link (``LINK_BW``'s keys); without it the
    collective bytes are priced on NVLink."""
    arch: str
    shape: str
    mesh: Tuple[int, ...]
    chips: int
    hlo_flops: float            # per rank
    hlo_bytes: float            # per rank
    collective_bytes: float     # per rank
    model_flops: float          # global (6*N_active*D)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    link_bytes: Optional[Dict[str, float]] = None

    def __post_init__(self):
        self.compute_s = (self.hlo_flops * self.chips) / (self.chips
                                                          * PEAK_BF16)
        self.memory_s = (self.hlo_bytes * self.chips) / (self.chips * HBM_BW)
        if self.link_bytes is None:
            self.collective_s = self.collective_bytes / NVLINK_BW
        else:
            self.collective_s = sum(b / LINK_BW[k]
                                    for k, b in self.link_bytes.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU bound implied by the dominant term."""
        if self.step_s == 0:
            return 0.0
        return self.model_flops / (self.step_s * self.chips * PEAK_BF16)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape,
            "mesh": "x".join(map(str, self.mesh)), "chips": self.chips,
            "hlo_gflops": round(self.hlo_flops / 1e9, 2),
            "hlo_gbytes": round(self.hlo_bytes / 1e9, 3),
            "coll_gbytes": round(self.collective_bytes / 1e9, 3),
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "dominant": self.dominant,
            "model_gflops": round(self.model_flops / 1e9, 2),
            "useful_ratio": round(self.useful_flops_ratio, 3),
            "roofline_frac": round(self.roofline_fraction, 4),
        }


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training; 2*N_active*tokens for single forward."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# The work of each hand-written kernel
# ---------------------------------------------------------------------------
CKPT_EVERY = 64             # steps between the recurrent kernels' checkpoints


def _flash_flops(b, s, kvp, gp, hd) -> int:
    # q k^T and p v over the causal triangle, 2 flops a multiply-add
    return 4 * hd * (s * (s + 1) // 2) * b * kvp * gp


def kernel_work(name: str, **shapes) -> Tuple[float, int, float]:
    """``(flops, bytes, peak)`` of one launch of kernel ``name``: the
    operations it must do on its inputs, the bytes it must move (each
    input read once, each output written once) and the card's peak rate
    for their type.  ``shapes`` name the launch's sizes:

    * ``paged_attention``: b, kvp, gp, hd, page, table (entries), blocks
      (pages the lengths cover), tokens (the lengths' sum); bf16 pools
    * ``int8_matmul``: m, k, n
    * ``flash_attention`` / ``flash_attention_bwd``: b, s, kvp, gp, hd,
      itemsize (2 for bf16, 4 for f32)
    * ``wkv`` / ``wkv_bwd``: b, s, h, n (``ds_fin``: the final state's
      gradient is read)
    * ``selective_scan`` / ``selective_scan_bwd``: b, s, dim, n
      (``dh_fin``: the final state's gradient is read); each also takes
      one exp a state cell and step, which ``kernel_bound`` prices
    * ``rowwise_quant``: m, k, itemsize
    * ``rowwise_quant_into`` (the fused int8 KV write of k and v):
      elements (of k), itemsize, written (rows written), hd
    """
    sh = shapes
    if name == "paged_attention":
        kv_bytes = 2 * sh["blocks"] * sh["page"] * sh["kvp"] * sh["hd"] * 2
        q_numel = sh["b"] * sh["kvp"] * sh["gp"] * sh["hd"]
        nbytes = kv_bytes + 2 * q_numel * 2 + 4 * sh["table"] + 4 * sh["b"]
        return (4 * sh["tokens"] * sh["kvp"] * sh["gp"] * sh["hd"], nbytes,
                PEAK_F32)
    if name == "int8_matmul":
        m, k, n = sh["m"], sh["k"], sh["n"]
        return 2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8
    if name in ("flash_attention", "flash_attention_bwd"):
        b, s, kvp, gp, hd = (sh[k] for k in ("b", "s", "kvp", "gp", "hd"))
        size = sh["itemsize"]
        peak = PEAK_BF16 if size == 2 else PEAK_F32
        q_numel, k_numel = b * s * kvp * gp * hd, b * s * kvp * hd
        flops = _flash_flops(b, s, kvp, gp, hd)
        if name == "flash_attention":
            # q, k, v read, out written
            return flops, size * (2 * q_numel + 2 * k_numel), peak
        # do, q, out and dq; k, v, dk, dv; lse read.  The backward
        # recomputes p and takes dv, dp, dq and dk: 2.5 forwards
        return (2.5 * flops,
                size * (4 * q_numel + 4 * k_numel) + 4 * b * kvp * s * gp,
                peak)
    if name in ("wkv", "wkv_bwd"):
        b, s, h, n = sh["b"], sh["s"], sh["h"], sh["n"]
        r_numel, u_numel = b * s * h * n, h * n
        if name == "wkv":
            # per (b, t, h): r^T S (2 N^2), the decay and rank-1 update of
            # S (3 N^2); the u-bonus term is O(N).  r, k, v, w, u read; y
            # and the final state written
            return (5 * n * n * b * s * h,
                    4 * (5 * r_numel + u_numel + b * h * n * n), PEAK_F32)
        # per (b, t, h): G (2 N^2), dr (4 N^2), dk, dw (2 N^2 each), dv's
        # product (N^2), dS's update (3 N^2).  r, k, v, w, dy, u and the
        # checkpoints read; dr, dk, dv, dw, du written (ds_fin read)
        ckpt = b * h * -(-s // CKPT_EVERY) * n * n
        return (14 * n * n * b * s * h,
                4 * (9 * r_numel + 2 * u_numel + ckpt
                     + (b * h * n * n if sh.get("ds_fin") else 0)),
                PEAK_F32)
    if name in ("selective_scan", "selective_scan_bwd"):
        b, s, dim, n = sh["b"], sh["s"], sh["dim"], sh["n"]
        cells, x_numel, b_numel = b * s * dim * n, b * s * dim, b * s * n
        if name == "selective_scan":
            # per (b, t, d, n): dt*a, dt*x*B, the state's fma and the
            # output's fma (6 flops) and one exp.  Each
            # input read once, y and the final state written once
            return (6 * cells,
                    4 * (3 * x_numel + 2 * b_numel + dim * n + dim
                         + b * dim * n), PEAK_F32)
        # per (b, t, d, n): dh's fma, dB and dC's products, dx's and ddt's
        # sums, dA's update and dh's decay (16 flops), one exp.  x, dt, dy,
        # B, C, A, D and the checkpoints read; dx, ddt, dB, dC, dA, dD
        # written (dh_fin read)
        ckpt = b * dim * -(-s // CKPT_EVERY) * n
        return (16 * cells,
                4 * (5 * x_numel + 4 * b_numel + 2 * dim * n + 2 * dim
                     + ckpt + (b * dim * n if sh.get("dh_fin") else 0)),
                PEAK_F32)
    if name == "rowwise_quant":
        # per element: abs, max, divide, round, clamp
        numel = sh["m"] * sh["k"]
        return 5 * numel, numel * sh["itemsize"] + numel + 4 * sh["m"], \
            PEAK_F32
    if name == "rowwise_quant_into":
        numel = sh["elements"]
        return (5 * 2 * numel,
                2 * numel * sh["itemsize"] + 2 * sh["written"] * (sh["hd"] + 4)
                + 4, PEAK_F32)
    raise ValueError(f"kernel_work: unknown kernel {name!r}")


def kernel_bound(name: str, sfu_per_s: Optional[float] = None, **shapes
                 ) -> Dict:
    """The least time the card could take for one launch of ``name``: the
    larger of its bytes over ``HBM_BW`` and its operations over their peak
    (and, given the card's special-function rate ``sfu_per_s``, the
    selective scans' exps over that), in ms, with the term that bounds
    it."""
    flops, nbytes, peak = kernel_work(name, **shapes)
    t_bytes = nbytes / HBM_BW * 1e3
    if sfu_per_s and name in ("selective_scan", "selective_scan_bwd"):
        exps = shapes["b"] * shapes["s"] * shapes["dim"] * shapes["n"]
        t_ops = max(exps / sfu_per_s, flops / peak) * 1e3
    else:
        t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}
