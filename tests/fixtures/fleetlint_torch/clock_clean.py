"""fleetlint fixture: the sanctioned twins of clock_bad.py."""
import torch


def noise(shape, seed):
    gen = torch.Generator().manual_seed(seed)    # explicit generator
    return torch.rand(shape, generator=gen)


def tokens(v, gen):
    return torch.randint(0, v, (4,), generator=gen)


def fill(x, gen):
    return x.normal_(generator=gen)


def pick(p, gen):
    return torch.multinomial(p, 1, generator=gen)


def clock(now_s):
    return now_s + 0.5                       # virtual time arrives as data
