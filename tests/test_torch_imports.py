"""The PyTorch port stands alone: every ``repro_torch`` module (and every
twin of an example) imports with JAX and ml_dtypes blocked, and no module
(nor ``chip_smoke.py``, the port's scripts, its example twins or its
tools' twins) imports JAX, ml_dtypes or the reference package ``repro``;
an example twin imports nothing of the reference's ``benchmarks/`` either.
Its entry points run on the card unless the caller asks for the CPU."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("*.py")) + TWINS
              + [ROOT / "tools" / f"{name}_torch.py"
                 for name in ("fleetlint", "hillclimb", "make_experiments")])


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_every_port_module_imports_with_jax_blocked():
    names = [_module_name(p) for p in sorted(PORT.rglob("*.py"))]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = sys.modules['ml_dtypes'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(names) >= 20


def test_every_example_twin_imports_with_jax_blocked():
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = sys.modules['ml_dtypes'] = None\n"
        f"for path in {[str(p) for p in TWINS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(TWINS) == 6


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    refused = ("jax", "jaxlib", "repro", "ml_dtypes")
    if path in TWINS:                 # a twin keeps its own copies
        refused += ("benchmarks",)
    bad = [m for m in imported if m.split(".")[0] in refused]
    assert not bad, f"{path}: imports {bad}"


ENTRY_POINTS = [
    ("repro_torch.bridge", "to_torch"),
    ("repro_torch.bridge", "to_tensor"),
    ("repro_torch.models.transformer", "model_init"),
    ("repro_torch.models.transformer", "init_cache"),
    ("repro_torch.models.transformer", "init_paged_decode_cache"),
    ("repro_torch.runtime.paging", "init_paged_cache"),
    ("repro_torch.runtime.serve", "ContinuousBatchingEngine"),
    ("repro_torch.models.rwkv", "init_rwkv_cache"),
    ("repro_torch.models.mamba", "init_mamba_cache"),
    ("repro_torch.models.attention", "init_kv_cache"),
    ("repro_torch.runtime.serve", "WindowedBaselineServer"),
    ("repro_torch.runtime.serve", "engine_or_windowed"),
    ("repro_torch.runtime.serve", "BatchingServer"),
    ("repro_torch.serving.spec", "FleetSpec.build"),
    ("repro_torch.serving.spec", "build_pool"),
    ("repro_torch.serving.spec", "make_server"),
    # ServingClient.add_pool builds on the device the client holds
    ("repro_torch.serving.client", "ServingClient"),
    ("repro_torch.models.cnn", "ursonet_init"),
    ("repro_torch.data.pipeline", "pose_batch"),
    ("repro_torch.pose", "train_ursonet"),
    ("repro_torch.pose", "eval_ursonet"),
    ("repro_torch.pose", "run_condition"),
    ("repro_torch.data.pipeline", "lm_batch"),
    ("repro_torch.models.frontends", "synthetic_frontend_embeds"),
    ("repro_torch.runtime.train_loop", "Trainer"),
    ("repro_torch.checkpoint.manager", "CheckpointManager.restore"),
]


@pytest.mark.parametrize("module,name", ENTRY_POINTS,
                         ids=[f"{m}.{n}" for m, n in ENTRY_POINTS])
def test_entry_point_defaults_to_the_card(module, name):
    import importlib
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
