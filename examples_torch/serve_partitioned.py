"""Pod-scale disaggregated serving through the PyTorch port's fleet facade
(the twin of ``examples/serve_partitioned.py``): an MPAI-partitioned model
with a dedicated prefill stage (the DPU analogue) fanning handoffs out to
TWO decode shards over the versioned wire format, streaming responses
end to end.

    PYTHONPATH=src python examples_torch/serve_partitioned.py [--device cpu]

Weights are the port's own seed-0 init on ``--device`` (default ``cuda``;
without a card the example stops rather than fall back); ``serve`` takes
any ``(cfg, params)``, so a caller may hand it other weights (the
reference's, through ``repro_torch.bridge``).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import require_device
from repro_torch.models import transformer as T
from repro_torch.serving import FleetSpec, PoolSpec


def model_config():
    # 4 layers so the mpai split=3 leaves a 3-layer int8 backbone ahead
    # of the high-precision tail, like the paper's UrsoNet deployment
    return get_config("qwen3-14b", smoke=True).with_(num_layers=4,
                                                     remat=False)


def init_params(cfg, device="cuda"):
    return T.model_init(cfg, torch.Generator(device).manual_seed(0),
                        device=device)


def build_fleet(cfg, params, device="cuda"):
    # one pool, three engines: a prefill stage feeding 2 decode shards.
    # Every handoff crosses the seam as serialized bytes (versioned +
    # checksummed) and lands on the least-loaded live shard.
    spec = FleetSpec(
        pools=[PoolSpec("board", ("tpu_v5e_int8", "tpu_v5e_bf16"),
                        backend="engine", capacity=1, max_window=4,
                        max_wait_s=0.0, max_slots=4, prompt_len=16,
                        max_new=8, plan="mpai", plan_split=3,
                        prefill_backend="engine", decode_shards=2)],
        workload="transformer", arch="qwen3-14b", seq_len=16)
    client = spec.build(model=(cfg, params), device=device)
    server = client.engines["board"]
    plan = server.decode.plan
    print(f"serving {server.decode.cfg.name}: "
          f"1 prefill stage -> {server.decode_shards} decode shards, "
          f"segments={[(s.name, s.policy.precision.value, s.policy.mode) for s in plan.segments]}")
    return client


def prompts(cfg):
    """The ten prompts, drawn as the reference draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size,
                         rng.integers(3, 16)).astype(np.int32)
            for _ in range(10)]


def serve(client, cfg) -> dict:
    handles = [client.submit(p, slo="offline", max_new=8)
               for p in prompts(cfg)]
    # stream the first response token-by-token while the rest decode in
    # the same slots (continuous batching: no window to wait out)
    print(f"  req 0 streams: {list(handles[0].stream())}")
    client.drain()
    tokens = {}
    for h in handles:
        r = h.result()
        tokens[r.rid] = [int(t) for t in r.tokens]
        print(f"  req {r.rid:2d}: prompt -> {r.tokens.tolist()}")
    pool = client.telemetry["pools"]["board"]
    pre = client.telemetry["pools"]["board.prefill"]
    print(f"disaggregated serving: {pool['tokens_generated']} tokens, "
          f"{pool['decode_tokens_per_s']:.0f} decode tok/s, occupancy "
          f"p50 {pool['slot_occupancy']['p50']}")
    print(f"  seam: {pre['prefill_tokens']} tokens prefilled, handoff "
          f"imports by shard {pool['imports_by_shard']}, prefix hit "
          f"rate {pool['prefix_hit_rate']:.2f}")
    return {"tokens": tokens, "imports_by_shard": pool["imports_by_shard"],
            "prefill_tokens": pre["prefill_tokens"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    cfg = model_config()
    params = init_params(cfg, args.device)
    client = build_fleet(cfg, params, args.device)
    return {**serve(client, cfg), "cfg": cfg, "params": params}


if __name__ == "__main__":
    main()
