"""fleetlint fixture: the clean twin of hostsync_bad.py (the same names
declared as device programs)."""
import numpy as np
import torch


def step(logits, lengths, budget):
    b, v = logits.shape
    best = logits.argmax(-1)
    if b > 1:                                # shape metadata: static
        best = best.clone()
    if budget is not None:                   # identity: no read
        best = torch.where(lengths > budget, best * 0, best)
    scale = float(np.float32(1.0) / np.float32(v))   # host math on shapes
    one = torch.tensor(float(v))             # a shape-derived scalar
    return best * scale, one


def derived(logits, eos):
    nxt = logits.argmax(-1)
    b = nxt.shape[0]                         # metadata of a derived tensor
    for i, blk in enumerate(range(b)):       # the index is a host int
        if i > 1:
            break
    if b > 1:
        nxt = torch.where(nxt == eos, nxt * 0, nxt)
    return nxt


class Engine:
    def decode(self, toks, temps):
        return torch.where(temps > 0, toks, toks + 1)
