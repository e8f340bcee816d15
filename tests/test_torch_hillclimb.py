"""The twins of ``tools/hillclimb.py`` and ``tools/make_experiments.py``
(``tools/hillclimb_torch.py``, ``tools/make_experiments_torch.py``) at a
smoke size.

* ``--list`` prints the reference's experiments in its order, and each
  experiment names the reference's arch, shape, pod count, plan and
  overrides (both files read with ``ast``: importing the reference's
  script would fake 512 host devices);
* one ``run`` of a smoke config in a fake world of 4 ranks writes the
  reference's artifact keys, less its probe keys, and prints its summary
  line;
* ``make_experiments_torch`` prints the dry-run table (every artifact)
  and the single-pod roofline table from a directory of two artifacts.
"""
import ast
import importlib.util
import json
import shutil
from pathlib import Path

import pytest

from repro_torch.configs.base import MeshConfig

ROOT = Path(__file__).resolve().parents[1]
# the keys of the reference's ``experiments/perf/<tag>.json``: its dry run's
# stats (``analyze``), then hillclimb's own
REFERENCE_KEYS = {"arch", "shape", "mesh", "compile_s", "flops", "hlo_bytes",
                  "temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "generated_code_size_in_bytes",
                  "collective_bytes", "collective_counts",
                  "collective_bytes_by_kind", "roofline", "variant",
                  "overrides", "plan", "wall_s"}
PROBE_KEYS = {"scanned_raw", "probe_s"}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _experiments(path: Path) -> dict:
    """``EXPERIMENTS``' entries of a hillclimb script, each as the ``run`` call its
    lambda makes: ``(positional args, keyword args)`` as literals."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "EXPERIMENTS":
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                call = v.body
                assert getattr(call.func, "id", None) == "run"
                out[ast.literal_eval(k)] = (
                    [ast.literal_eval(a) for a in call.args],
                    {kw.arg: ast.literal_eval(kw.value)
                     for kw in call.keywords})
            return out
    raise AssertionError(f"{path}: no EXPERIMENTS")


def test_list_prints_the_reference_experiments_in_order(capsys):
    want = list(_experiments(ROOT / "tools" / "hillclimb.py"))
    assert len(want) == 13
    assert _tool("hillclimb_torch").main(["--list"]) == 0
    assert capsys.readouterr().out.split() == want


def test_each_experiment_is_the_references():
    assert _experiments(ROOT / "tools" / "hillclimb_torch.py") == \
        _experiments(ROOT / "tools" / "hillclimb.py")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One ``run`` of ``qwen3-14b``'s smoke config at ``decode_32k`` under
    ``"mpai"`` on a fake (2, 2) world; returns ``(stats, directory,
    printed lines)``."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp("perf")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        stats = _tool("hillclimb_torch").run(
            "smoke_decode_mpai", "qwen3-14b", "decode_32k", plan="mpai",
            smoke=True, mesh_cfg=MeshConfig((2, 2), ("data", "model")),
            out_dir=str(out), remat_group=0)
    return stats, out, printed.getvalue().splitlines()


def test_run_writes_the_reference_keys_less_the_probes(artifact):
    stats, out, printed = artifact
    row = json.loads((out / "smoke_decode_mpai.json").read_text())
    assert REFERENCE_KEYS <= set(row)
    assert not PROBE_KEYS & set(row)
    assert row["variant"] == "smoke_decode_mpai" and row["plan"] == "mpai"
    assert row["overrides"] == {"remat_group": "0"}
    assert row["mesh"] == "2x2" and row["flops"] > 0
    assert row["roofline"]["shape"] == "decode_32k"
    assert printed == [
        f"smoke_decode_mpai: c/m/x = {row['roofline']['compute_ms']}/"
        f"{row['roofline']['memory_ms']}/{row['roofline']['collective_ms']}"
        f" ms dominant={row['roofline']['dominant']} "
        f"frac={row['roofline']['roofline_frac']} "
        f"useful={row['roofline']['useful_ratio']} "
        f"temp/dev={row['temp_size_in_bytes'] / 1e9:.1f}GB"]


def test_make_experiments_prints_both_tables(artifact, tmp_path, capsys):
    _, out, _ = artifact
    src = out / "smoke_decode_mpai.json"
    shutil.copy(src, tmp_path / "qwen3-14b__decode_32k__single.json")
    multi = json.loads(src.read_text())
    multi["mesh"] = "2x16x16"
    (tmp_path / "qwen3-14b__decode_32k__multi__mpai.json").write_text(
        json.dumps(multi))
    assert _tool("make_experiments_torch").main(["--dir", str(tmp_path)]) \
        == 0
    text = capsys.readouterr().out
    dry, roof = text.split("### Roofline table")
    rows = [ln for ln in dry.splitlines() if ln.startswith("| qwen3")]
    assert [r.split(" | ")[2:4] for r in rows] == [["2x16x16", "mpai"],
                                                   ["2x2", "bf16"]]
    roof_rows = [ln for ln in roof.splitlines() if ln.startswith("| qwen3")]
    assert len(roof_rows) == 1 and "| decode_32k |" in roof_rows[0]
