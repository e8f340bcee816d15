"""fleetlint fixture: host syncs inside device programs (SYN001-SYN005).

The test declares ``step``, ``derived``, ``Engine.decode`` and ``gone`` as device
programs (``budget`` a host argument of ``step``); ``gone`` does not
exist (SYN006)."""
import numpy as np
import torch


def step(logits, lengths, budget):
    best = logits.argmax(-1)
    n = best.max().item()                    # SYN001 (.item())
    if lengths.sum() > budget:               # SYN003 (tensor branch)
        best = best * 0
    host = np.asarray(lengths)               # SYN002 (numpy on tensor data)
    torch.cuda.synchronize()                 # SYN004
    cpu = best.to("cpu")                     # SYN004
    table = torch.tensor([1, 2, 3])          # SYN005 (host list)
    return best, n, host, cpu, table, int(lengths[0])   # SYN001 (int())


def derived(logits, eos):
    nxt = logits.argmax(-1)                  # a local computed on the card
    if (nxt == eos).any():                   # SYN003 (a derived tensor)
        nxt = nxt * 0
    for i, row in enumerate(nxt):
        if row > 0:                          # SYN003 (a row of one)
            break
    return int(nxt[0])                       # SYN001 (int() of one)


class Engine:
    def decode(self, toks, temps):
        return bool((temps > 0).any())       # SYN001 (bool())
