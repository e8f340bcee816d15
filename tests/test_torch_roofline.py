"""The port's roofline (``repro_torch.roofline``): ``model_flops`` equal to
the reference's for every arch and shape, ``RooflineReport``'s terms with
the H100 constants (as ``tests/test_roofline_parse.py`` tests v5e's), the
links a collective runs on, and ``kernel_work`` / ``kernel_bound`` for
each of the nine kernels, whose numbers ``chip_smoke.py`` reads."""
import pytest

from repro_torch import roofline as R
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_the_reference(arch):
    from repro import roofline as JR
    from repro.configs import get_config as jget
    from repro.configs.base import SHAPES as JSHAPES
    for name, shape in SHAPES.items():
        assert R.model_flops(get_config(arch), shape) == \
            JR.model_flops(jget(arch), JSHAPES[name])


def test_h100_constants():
    assert (R.PEAK_BF16, R.PEAK_INT8, R.PEAK_F32, R.HBM_BW) == \
        (989e12, 1979e12, 67e12, 3.35e12)
    assert R.LINK_BW == {"nvlink": 450e9, "network": 50e9}


def test_roofline_report_terms_and_dominant():
    from repro import roofline as JR
    rep = R.RooflineReport(arch="a", shape="s", mesh=(16, 16), chips=256,
                           hlo_flops=989e12 * 0.1,       # 100 ms compute
                           hlo_bytes=3.35e12 * 0.05,     # 50 ms memory
                           collective_bytes=450e9 * 0.2,  # 200 ms on NVLink
                           model_flops=1e15)
    assert abs(rep.compute_s - 0.1) < 1e-9
    assert abs(rep.memory_s - 0.05) < 1e-9
    assert abs(rep.collective_s - 0.2) < 1e-9
    assert rep.dominant == "collective"
    assert rep.step_s == rep.collective_s
    assert rep.useful_flops_ratio == pytest.approx(1e15 / (989e12 * 0.1
                                                           * 256))
    assert rep.roofline_fraction == pytest.approx(1e15 / (0.2 * 256
                                                          * 989e12))
    want = JR.RooflineReport(arch="a", shape="s", mesh=(16, 16), chips=256,
                             hlo_flops=1.0, hlo_bytes=1.0,
                             collective_bytes=1.0, model_flops=1.0).row()
    assert set(rep.row()) == set(want)
    assert rep.row()["dominant"] == "collective"
    assert rep.row()["mesh"] == "16x16"


def test_collective_term_prices_each_link():
    rep = R.RooflineReport(arch="a", shape="s", mesh=(16, 16), chips=256,
                           hlo_flops=0.0, hlo_bytes=0.0,
                           collective_bytes=1.0, model_flops=0.0,
                           link_bytes={"nvlink": 450e9 * 0.1,
                                       "network": 50e9 * 0.3})
    assert rep.collective_s == pytest.approx(0.4)
    assert rep.dominant == "collective"


@pytest.mark.parametrize("ranks,link", [
    (range(8), "nvlink"), (range(8, 16), "nvlink"), ([3], "nvlink"),
    (range(16), "network"), (range(0, 256, 16), "network"),
    ([7, 8], "network")])
def test_link_of_a_group(ranks, link):
    assert R.link_of(list(ranks)) == link


def test_wire_bytes_of_ring_collectives():
    assert R.wire_bytes("all-gather", 10.0, 16) == 150.0
    assert R.wire_bytes("all-reduce", 16.0, 4) == 24.0
    assert R.wire_bytes("all-reduce", 16.0, 1) == 0.0


# (kernel, shapes, flops, bytes, peak): the formulas written out by hand
WORK = [
    ("paged_attention", dict(b=2, kvp=2, gp=3, hd=8, page=4, table=6,
                             blocks=5, tokens=17),
     4 * 17 * 2 * 3 * 8, 2 * 5 * 4 * 2 * 8 * 2 + 2 * 96 * 2 + 24 + 8,
     R.PEAK_F32),
    ("int8_matmul", dict(m=8, k=16, n=32), 2 * 8 * 16 * 32,
     8 * 16 + 16 * 32 + 4 * 8 * 32, R.PEAK_INT8),
    ("flash_attention", dict(b=1, s=4, kvp=2, gp=3, hd=8, itemsize=2),
     4 * 8 * 10 * 6, 2 * (2 * 192 + 2 * 64), R.PEAK_BF16),
    ("flash_attention", dict(b=1, s=4, kvp=2, gp=3, hd=8, itemsize=4),
     4 * 8 * 10 * 6, 4 * (2 * 192 + 2 * 64), R.PEAK_F32),
    ("flash_attention_bwd", dict(b=1, s=4, kvp=2, gp=3, hd=8, itemsize=2),
     2.5 * 1920, 2 * (4 * 192 + 4 * 64) + 4 * 24, R.PEAK_BF16),
    ("wkv", dict(b=2, s=3, h=4, n=8), 5 * 64 * 24,
     4 * (5 * 192 + 32 + 2 * 4 * 64), R.PEAK_F32),
    ("wkv_bwd", dict(b=2, s=65, h=1, n=8), 14 * 64 * 130,
     4 * (9 * 1040 + 16 + 2 * 2 * 64), R.PEAK_F32),
    ("wkv_bwd", dict(b=2, s=65, h=1, n=8, ds_fin=True), 14 * 64 * 130,
     4 * (9 * 1040 + 16 + 2 * 2 * 64 + 2 * 64), R.PEAK_F32),
    ("selective_scan", dict(b=2, s=3, dim=4, n=8), 6 * 192,
     4 * (3 * 24 + 2 * 48 + 32 + 4 + 64), R.PEAK_F32),
    ("selective_scan_bwd", dict(b=2, s=3, dim=4, n=8, dh_fin=True),
     16 * 192, 4 * (5 * 24 + 4 * 48 + 64 + 8 + 64 + 64), R.PEAK_F32),
    ("rowwise_quant", dict(m=4, k=8, itemsize=2), 5 * 32, 64 + 32 + 16,
     R.PEAK_F32),
    ("rowwise_quant_into", dict(elements=48, itemsize=2, written=6, hd=8),
     10 * 48, 2 * 48 * 2 + 2 * 6 * 12 + 4, R.PEAK_F32),
]


@pytest.mark.parametrize("name,shapes,flops,nbytes,peak", WORK)
def test_kernel_work(name, shapes, flops, nbytes, peak):
    assert R.kernel_work(name, **shapes) == (flops, nbytes, peak)


def test_kernel_bound_takes_the_larger_term():
    b = R.kernel_bound("int8_matmul", m=8, k=4096, n=4096)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes_ms"] == \
        (8 * 4096 + 4096 * 4096 + 4 * 8 * 4096) / R.HBM_BW * 1e3
    b = R.kernel_bound("flash_attention", b=1, s=4096, kvp=8, gp=4, hd=128,
                       itemsize=2)
    assert b["bound_by"] == "operations"
    # the scans' exps on the special-function unit, where its rate is given
    plain = R.kernel_bound("selective_scan", b=8, s=128, dim=8192, n=16)
    sfu = R.kernel_bound("selective_scan", sfu_per_s=16 * 132 * 1980 * 1e6,
                         b=8, s=128, dim=8192, n=16)
    assert sfu["operations_ms"] == max(
        8 * 128 * 8192 * 16 / (16 * 132 * 1980 * 1e6),
        6 * 8 * 128 * 8192 * 16 / R.PEAK_F32) * 1e3
    assert sfu["operations_ms"] > plain["operations_ms"]


def test_unknown_kernel_is_refused():
    with pytest.raises(ValueError, match="unknown kernel"):
        R.kernel_work("matmul", m=1, k=1, n=1)


def test_chip_smoke_reads_its_bounds_from_the_roofline():
    import chip_smoke
    assert chip_smoke.roofline is R
    assert not [k for k in vars(chip_smoke) if k.startswith("PEAK_")]
