"""Stage-axis decode pool: one LM server spanning a stage pipeline (the
port of ``repro.serving.stage_executor``).

:class:`StageAxisEngine` backs a serving pool with the GPipe-style stage
pipeline of :mod:`repro_torch.core.pipeline` — segment 0 of the partition
plan (the int8 backbone, MPAI's DPU analogue, fake-quantized) runs as
stage 0, the high-precision tail and head as stage 1, and activations hand
off while stage 0 starts the next microbatch.  Each *slot* is one
microbatch, so a full step keeps every stage busy: slot i+1's backbone
overlaps slot i's tail.

Decode is full-sequence recompute: every step re-runs each slot's whole
token prefix, right-padded to ``max_len``, through the two stages and
samples the next token off the last real position's logits.  That is O(S)
per token instead of the paged engine's O(1), but it needs *no KV state
on any stage*: the pipeline stays a pure function of (params, tokens).

Serves the same ``submit`` / ``step`` / ``flush`` / ``done`` / ``stats``
API as the engines, so :class:`~repro_torch.serving.executor.EngineExecutor`
drives it unchanged and a ``PoolSpec(pipeline_stages=2)`` drops it into
any fleet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.partition import PartitionPlan
from repro_torch.core.pipeline import (lm_two_stage_fns, pipeline_apply,
                                       split_lm_params_for_stages)
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed
from repro_torch.runtime.sampling import GREEDY, sample_logits
from repro_torch.runtime.serve import Request, _require_prompt


@dataclass
class _StageSlot:
    req: Request
    gen: List[int] = field(default_factory=list)
    remaining: int = 0


class StageAxisEngine:
    """A decode server whose forward runs the two-stage pipeline.

    Stage ``s`` runs on ``cuda:(s % torch.cuda.device_count())`` when
    ``device`` is a CUDA device, so one card holds both stages on two
    streams; ``device="cpu"`` runs both on the CPU.  This is the one
    departure from the reference, which needs ``num_stages`` devices for
    its ``("stage",)`` mesh: the port serves on whatever devices exist, as
    its other servers do, and the tokens do not depend on the placement.
    The stage parameters are views of ``params`` (copied only to a stage
    on another card).
    """

    def __init__(self, params, cfg, num_stages: int = 2,
                 max_slots: int = 4, prompt_len: int = 16,
                 max_len: int = 24, block_size: int = 8,
                 plan: Optional[PartitionPlan] = None, tp: int = 1,
                 device="cuda"):
        if num_stages != 2:
            raise ValueError(
                f"stage-axis pools currently support exactly 2 stages "
                f"(the MPAI backbone/tail split); got {num_stages}")
        self.cfg = cfg
        self.params = params
        self.num_stages = num_stages
        self.max_slots = max_slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.block_size = block_size
        self.tp = tp
        self.device = torch.device(device)
        if self.device.type == "cuda":
            n = torch.cuda.device_count()
            self.devices = [torch.device("cuda", s % n)
                            for s in range(num_stages)]
        else:
            self.devices = [self.device] * num_stages

        period = T.pattern_period(cfg)
        n_super = cfg.num_layers // period
        if plan is None:
            if n_super % 2:
                raise ValueError(
                    f"stage-axis pools need an even super-block count to "
                    f"split two ways; {cfg.num_layers} layers / period "
                    f"{period} = {n_super}")
            plan = PartitionPlan.mpai(cfg.num_layers,
                                      split=(n_super // 2) * period)
        self.plan = plan.align_to_period(period, cfg.num_layers)
        s0, s1, _ = lm_two_stage_fns(cfg, self.plan, tp)
        self._fns = (s0, s1)
        # views of params; copied only to a stage on another card
        self._stage_params = [
            tree_map(lambda a, d=d: a.to(d), p) for p, d in zip(
                split_lm_params_for_stages(params, cfg, self.plan, period),
                self.devices)]
        self._emb_dtype = self.plan.embed_policy.precision.compute_dtype

        self.queue: List[Request] = []
        self.slots: List[Optional[_StageSlot]] = [None] * max_slots
        self.done: Dict[int, Request] = {}
        self.on_token: Optional[Callable[[int, int], None]] = None
        self.reset_stats()

    # ------------------------------------------------------------------
    # pipelined forward: one token per slot per call
    # ------------------------------------------------------------------
    def _decode(self, tokens, lengths, temps, topks, seeds, steps):
        """tokens [n_micro, S] int32 (right-padded: causality keeps the
        pad positions out of the last real logit); lengths [n_micro].
        Each slot is one microbatch of the stage pipeline.  Returns
        [n_micro] next tokens."""
        S = tokens.shape[1]
        x = embed(self.params["embed"], tokens, self._emb_dtype)
        outs = pipeline_apply(
            self.devices, self._fns, self._stage_params, x[:, None],
            hidden_shape=(1, S, self.cfg.d_model),
            out_shape=(1, S, self.cfg.vocab_size),
            hidden_dtype=torch.bfloat16, out_dtype=torch.float32)
        idx = torch.clamp(lengths.to(outs.device).long() - 1, 0, S - 1)
        logits = torch.gather(
            outs[:, 0], 1,
            idx[:, None, None].expand(-1, 1, outs.shape[-1]))[:, 0]
        dev = logits.device
        return sample_logits(logits, temps.to(dev), topks.to(dev),
                             seeds.to(dev), steps.to(dev))

    # ------------------------------------------------------------------
    # server API
    # ------------------------------------------------------------------
    def padded_prompt_len(self, s: int) -> int:
        return max(s, self.prompt_len)

    @property
    def pending(self) -> int:
        return len(self.queue) + sum(s is not None for s in self.slots)

    @property
    def occupancy(self) -> float:
        return sum(s is not None for s in self.slots) / self.max_slots

    def submit(self, req: Request) -> None:
        _require_prompt(req, "stage-axis engine")
        n = int(req.prompt.shape[0])
        if n > self.prompt_len:
            raise ValueError(
                f"request {req.rid}: prompt of {n} tokens exceeds this "
                f"stage-axis pool's prompt_len bucket of "
                f"{self.prompt_len} (chunked prefill is a paged-pool "
                f"feature)")
        assert n + req.max_new <= self.max_len, \
            (req.rid, n, req.max_new, self.max_len)
        self.queue.append(req)

    def step(self) -> List[Request]:
        completed: List[Request] = []
        t0 = time.perf_counter()
        for i in range(self.max_slots):        # admit into free slots
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = _StageSlot(req, [], req.max_new)
                self.prefill_tokens += int(req.prompt.shape[0])
        self.admit_s += time.perf_counter() - t0
        active = [i for i in range(self.max_slots)
                  if self.slots[i] is not None]
        if not active:
            return completed
        S = self.max_len
        tokens = np.zeros((self.max_slots, S), np.int32)
        lengths = np.ones(self.max_slots, np.int32)
        temps = np.zeros(self.max_slots, np.float32)
        topks = np.zeros(self.max_slots, np.int32)
        seeds = np.zeros(self.max_slots, np.int32)
        steps = np.zeros(self.max_slots, np.int32)
        for i in active:
            s = self.slots[i]
            seq = list(map(int, s.req.prompt)) + s.gen
            tokens[i, :len(seq)] = seq
            lengths[i] = len(seq)
            sp = s.req.sampling or GREEDY
            temps[i], topks[i] = sp.temperature, sp.top_k
            seeds[i], steps[i] = sp.seed, len(s.gen)
        t0 = time.perf_counter()
        dev = self.devices[0]
        nxt = self._decode(*(torch.tensor(a, device=dev) for a in
                             (tokens, lengths, temps, topks, seeds,
                              steps))).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.occupancy_sum += self.occupancy
        for i in active:
            s = self.slots[i]
            tok = int(nxt[i])
            s.gen.append(tok)
            s.remaining -= 1
            self.total_tokens += 1
            self.decode_tokens += 1
            if self.on_token is not None:
                self.on_token(s.req.rid, tok)
            if s.remaining == 0:
                s.req.output = np.asarray(s.gen, np.int32)
                self.done[s.req.rid] = s.req
                completed.append(s.req)
                self.slots[i] = None
        return completed

    def flush(self) -> List[Request]:
        """Blocking form: run until at least one request completes."""
        if not self.pending:
            return []
        while True:
            done = self.step()
            if done:
                return done

    def stats(self) -> Dict[str, float]:
        steps = max(self.decode_steps, 1)
        return {"total_tokens": self.total_tokens,
                "decode_steps": self.decode_steps,
                "mean_occupancy": self.occupancy_sum / steps,
                "decode_tokens": self.decode_tokens,
                "decode_s": self.decode_s,
                "admit_s": self.admit_s,
                "prefill_tokens": self.prefill_tokens,
                "deferrals": self.deferrals,
                "num_stages": self.num_stages}

    def reset_stats(self) -> None:
        self.total_tokens = 0
        self.decode_steps = 0
        self.occupancy_sum = 0.0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.admit_s = 0.0
        self.prefill_tokens = 0
        self.deferrals = 0                 # no paged admission -> always 0
