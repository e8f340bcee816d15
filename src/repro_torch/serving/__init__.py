"""repro_torch.serving — the one serving API over the heterogeneous fleet
(the port of ``repro.serving``).

MPAI's architectural claim is a *single submission interface* in front
of co-processors: the host dispatches each inference to whichever
accelerator operating point fits, and the caller never learns which
device ran it.  This package is that front door for the port —
declarative fleet specs, one client, streaming responses.  A fleet JSON
written by the reference loads unchanged and serves through the port's
engines, on the card unless ``build(device="cpu")`` asks otherwise:

    import json
    from repro_torch.serving import FleetSpec, open_loop

    spec = FleetSpec.from_dict(json.loads(text))      # reference JSON
    client = spec.build(model=(cfg, params))          # device="cuda"
    handle = client.submit(prompt_tokens, slo="offline", max_new=16)
    for tok in handle.stream():          # tokens arrive per decode step
        ...
    print(handle.result(), client.telemetry)

Layers (one module per concern)::

    spec.py     FleetSpec / PoolSpec / FaultSpec — fleets as data; dict/
                JSON round-trip; build() assembles Router + pools +
                engines; make_server() is the only sanctioned decode-
                server constructor; build_pool() the shared per-pool
                assembly path (spec build and live growth)
    client.py   ServingClient (submit/step/drain + fleet clock), live
                fleet mutation (add_pool / retire_pool / set_capacity —
                retirements drain gracefully), and ResponseHandle
                (.result / .stream / .telemetry)
    executor.py EngineExecutor — adapts the continuous-batching engine
                to the router's executor protocol: LMWork payloads,
                per-token relay, decode-only tokens/s, OutOfBlocks
                deferrals as backpressure telemetry
    traffic.py  Poisson open-loop traffic generator

Requests may sample (``SamplingParams``: temperature, top-k, seed; the
reference's threefry key stream bit for bit), and engine pools may be
hardened (``PoolSpec(harden=True)``, or the target of a ``kv_bitflip`` /
``slot_stall`` ``FaultSpec``).  An engine pool with ``prefill_backend=
"engine"`` splits into MPAI's co-processing stages (a prefill engine under
``prefill_plan`` feeding ``decode_shards`` decode engines through
``runtime.serve.CoProcServer``, its prefill stage charged to the
``<pool>.prefill`` pool), and a ``handoff_loss`` fault cuts its seam.  A
pool with ``pipeline_stages=2`` serves through the ``StageAxisEngine`` of
``serving/stage_executor.py``: the fake-quantized int8 backbone and the
bf16 tail as two stages of ``core.pipeline.pipeline_apply``.
"""
from repro_torch.router.slo import SLO_CLASSES, SLOClass
from repro_torch.runtime.sampling import GREEDY, SamplingParams
from repro_torch.serving.client import Response, ResponseHandle, ServingClient
from repro_torch.serving.executor import EngineExecutor, LMWork
from repro_torch.serving.spec import (DEFAULT_SLOS, FaultSpec, FleetSpec,
                                      PoolSpec, build_pool, make_server)
from repro_torch.serving.traffic import (TrafficTrace, open_loop,
                                         poisson_arrivals)

__all__ = [
    "DEFAULT_SLOS", "EngineExecutor", "FaultSpec", "FleetSpec", "GREEDY",
    "LMWork", "PoolSpec", "Response", "ResponseHandle", "SLOClass",
    "SLO_CLASSES", "SamplingParams", "ServingClient", "TrafficTrace",
    "build_pool", "make_server", "open_loop", "poisson_arrivals",
]
