"""Serving launcher: batched requests against an MPAI-partitioned model,
through the ``repro_torch.serving`` facade (the port of
``repro.launch.serve``), on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --plan mpai --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --smoke --plan mpai --device cpu

Without ``--smoke`` the arch runs at its full width from the port's seeded
init (``qwen3-14b``: 59 GB of f32 weights on the card).

Throughput note: tokens/s is reported *decode-only* (sampled decode
tokens over wall time inside decode steps), so prefill-window idle time
never mixes into the number.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch import require_device
from repro_torch.serving import FleetSpec, PoolSpec


def main(argv=None) -> dict:
    """Serve ``--requests`` requests and print the pool's line; returns
    the served and token counts, the handles' token counts, the pool's
    telemetry and, with ``--trace``, the trace's event count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--plan", default="mpai", choices=["bf16", "mpai"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace_event JSON of the run "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (the card unless 'cpu')")
    args = ap.parse_args(argv)
    require_device(ap, args.device)

    spec = FleetSpec(
        pools=[PoolSpec("serve", ("tpu_v5e_bf16",), backend="engine",
                        capacity=1, max_window=args.max_batch,
                        max_wait_s=0.0, max_slots=args.max_batch,
                        prompt_len=16, max_new=args.max_new,
                        plan=args.plan if args.plan == "mpai" else None)],
        workload="transformer", arch=args.arch, smoke=args.smoke,
        seq_len=16)
    client = spec.build(device=args.device)
    if args.trace:
        client.enable_tracing()

    rng = np.random.default_rng(0)
    vocab = client.engines["serve"].cfg.vocab_size
    handles = [client.submit(
        rng.integers(0, vocab, rng.integers(2, 16)).astype(np.int32),
        slo="offline", max_new=args.max_new)
        for _ in range(args.requests)]
    client.drain()

    pool = client.telemetry["pools"]["serve"]
    served = sum(h.admitted and not h.telemetry["dropped"]
                 for h in handles)
    print(f"served {served} requests / {pool['tokens_generated']} tokens "
          f"in {pool['batches']} batches, {pool['busy_s']:.2f}s busy "
          f"({pool['decode_tokens_per_s']:.1f} decode tok/s, "
          f"occupancy p50 {pool['slot_occupancy']['p50']})")
    out = {"served": served, "tokens": [len(h.tokens) for h in handles],
           "pool": pool}
    if args.trace:
        from repro_torch.obs import export_chrome_trace
        trace = export_chrome_trace(client, args.trace)
        print(f"wrote {len(trace['traceEvents'])} trace events to "
              f"{args.trace}")
        out["trace_events"] = len(trace["traceEvents"])
    return out


if __name__ == "__main__":
    main()
