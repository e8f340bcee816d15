"""fleetlint fixture: virtual-clock purity violations in torch code
(VCP001/VCP002)."""
import time

import torch


def stamp():
    return time.monotonic()                  # VCP001


def reseed():
    torch.manual_seed(0)                     # VCP002 (global generator)


def noise(shape):
    return torch.rand(shape)                 # VCP002 (no generator=)


def tokens(v):
    return torch.randint(0, v, (4,))         # VCP002 (no generator=)


def fill(x):
    return x.normal_()                       # VCP002 (in-place, global)


def pick(p):
    return torch.multinomial(p, 1)           # VCP002 (no generator=)
