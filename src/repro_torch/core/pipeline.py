"""Co-processing stage pipeline — the DPU->VPU handoff as a device
pipeline (the port of ``repro.core.pipeline``).

The paper streams activations from the INT8 engine to the FP16 engine over
a board-level link.  Here each stage is a device and a CUDA stream: stage
``s`` holds segment ``s``'s parameters and runs its precision policy, and
hands its activations to stage ``s+1`` while it starts the next microbatch
— the GPipe schedule with depth-1 handoffs.  The reference runs the stages
as one ``shard_map`` program over a mesh axis, handing off with
``lax.ppermute``; the port gives each stage its own device and stream and
orders each handoff with a CUDA event.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch

# one stream per (device, stage), kept across calls: two stages on one card
# keep two streams, and the caching allocator's per-stream pools are reused
# by every step instead of growing one pool per new stream
_STREAMS: Dict[Tuple[torch.device, int], "torch.cuda.Stream"] = {}


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _stage_stream(device: torch.device, stage: int):
    key = (device, stage)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def pipeline_apply(devices: Sequence, stage_fns: Sequence[Callable],
                   stage_params: Sequence, micro_inputs: torch.Tensor,
                   hidden_shape: tuple, out_shape: tuple,
                   hidden_dtype=torch.bfloat16,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Run ``micro_inputs`` [n_micro, ...] through a linear stage pipeline.

    ``stage_fns[s](x, stage_params[s])`` runs stage ``s`` on
    ``devices[s]``: every stage but the last returns the hidden it hands
    on (``hidden_shape``), the last returns the output (``out_shape``).
    Stage 0's feed is cast to ``hidden_dtype``, every handoff is in
    ``hidden_dtype`` and the outputs are cast to ``out_dtype``.  Returns
    ``[n_micro, *out_shape]`` on the last stage's device.

    The schedule is the reference's: at step ``t`` stage ``s`` takes
    microbatch ``t - s``, and only real (stage, microbatch) pairs run (the
    reference also computes on clipped feeds during fill and drain and
    throws those results away).  It only reorders independent work, so
    the result is bit-equal to running the stages one after the other.

    On CUDA each stage runs on a stream of its own.  A handoff is recorded
    as an event on the producing stream, and the consuming stream waits
    on that event; the hidden is then copied onto the next stage's device,
    or, where both stages share one, read in place (``record_stream``
    keeps the allocator from reusing it while the next stage still reads
    it).  Two stages on one card, as on a machine with one H100, thus keep
    separate streams on one device: stage 0's work on microbatch ``i+1``
    overlaps stage 1's work on microbatch ``i``, the single-card form of
    the reference's ``ppermute``.  On the CPU the stages run in schedule
    order on the calling thread.
    """
    devices = [_device(d) for d in devices]
    num_stages, n_micro = len(stage_fns), micro_inputs.shape[0]
    if not (len(devices) == len(stage_params) == num_stages):
        raise ValueError(f"{num_stages} stage functions, {len(devices)} "
                         f"devices, {len(stage_params)} parameter trees")
    cuda = devices[0].type == "cuda"
    streams = ([_stage_stream(d, s) for s, d in enumerate(devices)]
               if cuda else [None] * num_stages)
    if cuda:
        caller = torch.cuda.current_stream(micro_inputs.device)
        for st in streams:
            st.wait_stream(caller)       # the feed and the weights are ready
    outs = torch.empty((n_micro,) + tuple(out_shape), dtype=out_dtype,
                       device=devices[-1])
    handoff: List = [None] * num_stages  # (hidden, event) waiting at stage s
    keep = []          # hiddens copied across cards: held until the end
    for t in range(n_micro + num_stages - 1):
        # the last stage first: it drains the handoff the stage before it
        # made at step t-1, which that stage's step-t output replaces
        for s in reversed(range(num_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            with (torch.cuda.stream(streams[s]) if cuda
                  else contextlib.nullcontext()):
                if s == 0:
                    x = micro_inputs[m].to(hidden_dtype)
                else:
                    x, event = handoff[s]
                    handoff[s] = None
                    if event is not None:
                        streams[s].wait_event(event)
                        if x.device == devices[s]:
                            x.record_stream(streams[s])
                        else:
                            keep.append(x)
                            x = x.to(devices[s], non_blocking=True)
                y = stage_fns[s](x, stage_params[s])
                if s == num_stages - 1:
                    _check_shape(y, out_shape, "output", s)
                    outs[m].copy_(y)
                    continue
                _check_shape(y, hidden_shape, "hidden", s)
                y = y.to(hidden_dtype)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(streams[s])
                handoff[s + 1] = (y, event)
    if cuda:
        caller = torch.cuda.current_stream(outs.device)
        for st in streams:
            caller.wait_stream(st)
    return outs


def _check_shape(y: torch.Tensor, want: tuple, what: str, stage: int):
    if tuple(y.shape) != tuple(want):
        raise ValueError(f"stage {stage} returned a {what} of shape "
                         f"{tuple(y.shape)}, expected {tuple(want)}")


# ---------------------------------------------------------------------------
# LM convenience: two-stage MPAI serve pipeline
# ---------------------------------------------------------------------------
def lm_two_stage_fns(cfg, plan, tp: int = 1):
    """``(stage0_fn, stage1_fn, (seg0, seg1))`` for an LM split at
    ``plan.segments[0].end`` (aligned to the layer-pattern period).

    Stage 0: the embedded microbatch [B, S, d] through the backbone
    segment under its policy; returns the hidden.  Stage 1: the tail
    segment, the final rmsnorm and the head under ``plan.head_policy``;
    returns f32 logits [B, S, V].  Positions are ``arange(S)``.  Stage
    params: :func:`split_lm_params_for_stages`.
    """
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits, rmsnorm

    period = T.pattern_period(cfg)
    plan = plan.align_to_period(period, cfg.num_layers)
    seg0, seg1 = plan.segments[0], plan.segments[-1]

    def positions(x):
        return torch.arange(x.shape[1], dtype=torch.int32,
                            device=x.device).expand(x.shape[:2])

    def stage0(x, params):
        return T.segment_apply(params["layers"], cfg, x, positions(x),
                               seg0.policy, tp)[0]

    def stage1(x, params):
        x = T.segment_apply(params["layers"], cfg, x, positions(x),
                            seg1.policy, tp)[0]
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params["lm_head"], x, plan.head_policy).float()

    return stage0, stage1, (seg0, seg1)


def split_lm_params_for_stages(params, cfg, plan, period: int):
    """One parameter tree per stage, every leaf a view of ``params``:
    stage 0 the backbone's super-blocks, stage 1 the tail's with the final
    norm and the head table.  The reference pads stage 0 with a zero head
    and norm so that JAX can stack the two trees; nothing here is copied
    (a stacked copy of Qwen3-14B's f32 weights would not fit the card)."""
    from repro_torch.models.transformer import slice_stack

    seg0, seg1 = plan.segments[0], plan.segments[-1]
    lo = seg0.end // period
    n0, n1 = lo, (seg1.end - seg1.start) // period
    assert n0 == n1, ("two-stage pipeline requires equal segment lengths; "
                      f"got {n0} vs {n1} super-blocks")
    table = params["embed"] if "lm_head" not in params else params["lm_head"]
    return [{"layers": slice_stack(params["layers"], 0, lo)},
            {"layers": slice_stack(params["layers"], lo, lo + n1),
             "final_norm": params["final_norm"], "lm_head": table}]
