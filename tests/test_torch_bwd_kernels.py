"""The backward kernels of the recurrences (``csrc/wkv_bwd.cu``,
``csrc/selective_scan_bwd.cu``): their launch plans on the CPU, and on the
card (``cuda``) each kernel against its plain version over every compiled
head or state size, ragged and short sequences, one and many chunks, grids
smaller and larger than the card, with and without the final state's
gradient, and two launches bit-equal.

The wkv backward carries dS to every chunk boundary, then walks each chunk
with its state columns split over a thread-block cluster (``wkv.bwd_plan``);
the scan's splits its sequence the same way where its blocks do not fill
the card (``selective_scan.bwd_plan``), and the split carries dh with the
walk's own arithmetic, so dx, ddt, dB and dC are the same bits either way.
Tolerances as ``tests/test_torch_recurrent_train.py``: wkv within 1e-5 of
each gradient's norm (f32 sums in another order), the scan within 1e-4
(``ex2.approx`` against ``exp``).  This file imports no JAX: the card has
none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import wkv as twkv

H100_SMS = 132


# ---------------------------------------------------------------------------
# the launch plans (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,cluster", [(8, 1), (16, 1), (32, 2), (64, 2)])
def test_wkv_plan_splits_columns_over_a_cluster(n, cluster):
    assert n in twkv.BWD_HEAD_SIZES
    assert twkv.bwd_plan(4096, n).cluster == cluster
    assert n // twkv.bwd_plan(37, n).cluster == twkv.BWD_CTA_COLS[n]


@pytest.mark.parametrize("s,chunks", [(0, 0), (1, 1), (7, 1), (37, 1),
                                      (64, 1), (65, 2), (130, 3),
                                      (4096, 64)])
def test_wkv_plan_carries_ds_when_there_is_more_than_one_chunk(s, chunks):
    p = twkv.bwd_plan(s, 64)
    assert p.chunks == chunks == -(-s // twkv.CKPT_EVERY)
    assert p.split == (chunks > 1)


@pytest.mark.parametrize("n", [4, 12, 128, 256])
def test_wkv_plan_refuses_head_sizes_the_kernel_does_not_compile(n):
    with pytest.raises(ValueError, match="head size"):
        twkv.bwd_plan(37, n)


def test_wkv_plan_refuses_a_negative_length():
    with pytest.raises(ValueError, match="sequence length"):
        twkv.bwd_plan(-1, 64)


# (B, S, D, N, SMs, split): Jamba's d_inner 8192 at N 16 has 128 channel
# blocks; a grid under two blocks an SM splits, one chunk never does
SCAN_PLANS = [(1, 2048, 8192, 16, H100_SMS, True),
              (8, 128, 8192, 16, H100_SMS, False),
              (3, 37, 8192, 16, H100_SMS, False),
              (1, 64, 8192, 16, H100_SMS, False),
              (1, 65, 8192, 16, H100_SMS, True),
              (2, 130, 8192, 16, H100_SMS, True),
              (3, 130, 8192, 16, H100_SMS, False),
              (8, 128, 8192, 16, 1024, True),
              (1, 130, 100, 64, H100_SMS, True),
              (64, 130, 100, 4, H100_SMS, True)]


@pytest.mark.parametrize("b,s,dim,n,sms,split", SCAN_PLANS)
def test_scan_plan_splits_where_its_blocks_do_not_fill_the_card(
        b, s, dim, n, sms, split):
    p = tss.bwd_plan(b, s, dim, n, sms)
    assert p.chunks == -(-s // tss.CKPT_EVERY)
    assert p.split == split
    if p.chunks > 1:
        fills = (b * tss.bwd_blocks(dim, n)
                 >= tss.BWD_BLOCKS_PER_SM * sms)
        assert p.split == (not fills)


@pytest.mark.parametrize("n", [2, 12, 128])
def test_scan_plan_refuses_state_sizes_the_kernel_does_not_compile(n):
    with pytest.raises(ValueError, match="state size"):
        tss.bwd_plan(1, 37, 100, n, H100_SMS)


@pytest.mark.parametrize("n,blocks", [(4, 1), (8, 1), (16, 2), (32, 4),
                                      (64, 7)])
def test_scan_backward_blocks_cover_the_channels(n, blocks):
    """100 channels over blocks of 256 threads, N / 4 lanes a channel."""
    assert tss.bwd_blocks(100, n) == blocks


def test_backward_wrappers_refuse_cpu_tensors():
    """On the CPU the autograd functions take the plain versions; the
    kernel wrappers launch on CUDA tensors only, and never fall back."""
    r, k, v, w, dy = (torch.zeros((1, 5, 2, 8)) for _ in range(5))
    u = torch.zeros((2, 8))
    ckpt = torch.zeros((1, 2, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv_bwd(r, k, v, w, u, ckpt, dy)
    x, dt, dyy = (torch.zeros((1, 5, 3)) for _ in range(3))
    bm, cm = torch.zeros((1, 5, 4)), torch.zeros((1, 5, 4))
    a, d = torch.zeros((3, 4)), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_bwd(x, dt, bm, cm, a, d,
                               torch.zeros((1, 3, 1, 4)), dyy)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
def _wkv_inputs(b, s, h, n, seed):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(size=(b, s, h, n)).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.normal(size=(b, s, h, n)) - 1)).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    ds = rng.normal(size=(b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, dy, ds


def _scan_inputs(b, s, dim, n, seed):
    rng = np.random.default_rng(seed)
    x, dy = (rng.normal(size=(b, s, dim)).astype(np.float32)
             for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, dim)) - 3)).astype(
        np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (dim, 1))
    d = rng.normal(size=(dim,)).astype(np.float32)
    dh = rng.normal(size=(b, dim, n)).astype(np.float32)
    return x, dt, bm, cm, a, d, dy, dh


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


# (B, S, H, N): every compiled N; S shorter than a sub-chunk of 8, not a
# multiple of 8, exactly one chunk, ragged over three chunks; grids of 2 to
# 480 clusters (132 SMs)
WKV_CASES = ([(1, s, 2, n) for n in twkv.BWD_HEAD_SIZES
              for s in (1, 5, 37, 64, 130)]
             + [(4, 130, 40, 64), (2, 300, 40, 64), (3, 77, 5, 32)])


@pytest.mark.cuda
@pytest.mark.parametrize("with_ds", [True, False], ids=["ds_fin", "no_ds"])
@pytest.mark.parametrize("case", WKV_CASES,
                         ids=["-".join(map(str, c)) for c in WKV_CASES])
def test_wkv_backward_kernel_equals_its_plain_version(card, case, with_ds):
    b, s, h, n = case
    r, k, v, w, u, dy, ds = (torch.from_numpy(t).to(card)
                             for t in _wkv_inputs(*case, seed=s * n + b))
    ds = ds if with_ds else None
    _, _, ckpt = twkv._launch(r, k, v, w, u, checkpoints=True)
    before = twkv.wkv_bwd.launches
    got = twkv.wkv_bwd(r, k, v, w, u, ckpt, dy, ds)
    again = twkv.wkv_bwd(r, k, v, w, u, ckpt, dy, ds)
    torch.cuda.synchronize()
    assert twkv.wkv_bwd.launches == before + 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = twkv.wkv_bwd_plain(r, k, v, w, u, dy, ds)
    for g, t in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, t) <= 1e-5


@pytest.mark.cuda
def test_wkv_backward_clusters_are_resident(card):
    """The walk's clusters fit the card (``cudaOccupancyMaxActiveClusters``
    at the RWKV-6 3B training layer's launch)."""
    assert twkv.bwd_clusters(4, 4096, 40, 64) >= 1


# (B, S, D, N): every compiled N; one chunk (S 5, 37), two (S 70, 128),
# three ragged (130) and 32 (2048); D ragged (100, 33) or Jamba's 8192
SCAN_CASES = ([(1, s, 100, n) for n in tss.STATE_SIZES
               for s in (5, 37, 70, 130)]
              + [(2, 128, 33, 8), (1, 2048, 8192, 16), (3, 37, 8192, 16),
                 (8, 128, 8192, 16)])


def _split(monkeypatch, split):
    """Force the scan backward's sequence split on or off."""
    chosen = tss.bwd_plan
    monkeypatch.setattr(tss, "bwd_plan",
                        lambda *shape: chosen(*shape)._replace(split=split))


@pytest.mark.cuda
@pytest.mark.parametrize("with_dh", [True, False], ids=["dh_fin", "no_dh"])
@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=["-".join(map(str, c)) for c in SCAN_CASES])
def test_scan_backward_kernel_equals_its_plain_version_split_or_not(
        card, case, with_dh, monkeypatch):
    x, dt, bm, cm, a, d, dy, dh = (
        torch.from_numpy(t).to(card)
        for t in _scan_inputs(*case, seed=case[1] + case[2] + case[3]))
    dh = dh if with_dh else None
    _, _, ckpt = tss._launch(x, dt, bm, cm, a, d, checkpoints=True)
    want = tss.selective_scan_bwd_plain(x, dt, bm, cm, a, d, dy, dh)
    runs = {}
    for split in (False, True):
        _split(monkeypatch, split)
        got = tss.selective_scan_bwd(x, dt, bm, cm, a, d, ckpt, dy, dh)
        again = tss.selective_scan_bwd(x, dt, bm, cm, a, d, ckpt, dy, dh)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        for g, t in zip(got, want):
            assert torch.isfinite(g).all()
            assert _rel(g, t) <= 1e-4
        runs[split] = got
        monkeypatch.undo()
    # the carry repeats the walk's arithmetic: dx, ddt, dB and dC agree bit
    # for bit (dA and dD add per-chunk partials in another order)
    for p, q in zip(runs[False][:4], runs[True][:4]):
        assert torch.equal(p, q)
