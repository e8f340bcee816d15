"""repro_torch.launch — the port's command-line launchers (the port of
``repro.launch``), each run as ``python -m repro_torch.launch.<name>``:

* ``serve`` — batched requests against one engine pool of an arch, under
  the bf16 or the ``"mpai"`` plan;
* ``route`` — the vision fleet under a fault and failover, the LM
  cost-model fleet, and real decode through an engine pool;
* ``orbit`` — the vision fleet through an eclipse, controller on or off;
* ``top`` — the same orbit as a text dashboard over the SLO engine;
* ``train`` — an LM trained through the fault-tolerant runner, under the
  bf16 or the ``"mpai"`` (fake-quantized backbone) plan.

A launcher that decodes or trains runs on ``--device``: the card unless
the caller asks for ``cpu``; without a card it stops, it never falls back.
"""


def require_device(parser, device: str) -> None:
    """Stop the launcher through ``parser.error`` (exit code 2) when
    ``device`` names a CUDA card and none is present."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device here; pass "
                     f"--device cpu to run on the CPU")
