"""The port's co-processing seam against ``repro.runtime.serve``: the
``PrefillHandoff`` wire format, the engines' ``prefill_handoff`` /
``import_prefill`` / ``restore_import`` and ``CoProcServer``.

Wire format v1 (``repro/serving/WIRE_FORMAT.md``), in one process: the
port's round trip is bit-exact for float32, float16, bfloat16 (and the fp8
and integer dtypes torch names), with and without digests; a truncated
frame, a bad magic, another version and an unknown dtype raise
``HandoffWireError``, a flipped payload bit ``HandoffCorruptError``; the
port's frame equals the reference's byte for byte for the same content and
each package parses the other's.

Engines, against the reference run in a subprocess with XLA's excess
precision off and synchronous dispatch (as in ``test_torch_engine.py``),
with the reference's weights through ``repro_torch.bridge``, at the
reference tests' geometry (prompt bucket 8, max_len 48, blocks of 4): a
frame the reference's prefill engine made decodes on a port decode engine
to the reference's own tokens, and a port frame on the reference's decode
engine to the port's (greedy streams may part only at a near-tie of the
top two logits); ``CoProcServer`` gives the reference's tokens, token
streams (every token once), ``stats()`` and allocator books with two
shards, one shard, a shard retired mid-run, a corrupted wire frame, a
lost handoff, per-shard backpressure, an "mpai" prefill stage feeding bf16
shards, sampled requests, hardened shards whose bit-flip evictions come
back through the seam (``restore_import``) and a digest mismatch at
import; and the single-decode-engine split cases of
``tests/test_serve_engine.py`` (split equals unified, streams exactly
once, a wide prefill chunk equals a narrow one, seam backpressure)."""
import functools
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.models import transformer as T
from repro_torch.runtime import paging
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.serve import (WIRE_VERSION, ContinuousBatchingEngine,
                                       CoProcServer, HandoffCorruptError,
                                       HandoffWireError, PrefillHandoff,
                                       Request)

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LEN, MAX_LEN, BLOCK = 8, 48, 4
TIMING = ("decode_s", "admit_s")


# ---------------------------------------------------------------------------
# workloads and scenarios (shared with the reference's subprocess)
# ---------------------------------------------------------------------------
def _requests(name: str):
    """(rid, prompt, max_new) triples: ``tests/test_disagg.py``'s
    ``_workload`` ("disagg", "disagg4") and the co-processing cases of
    ``tests/test_serve_engine.py``."""
    if name in ("disagg", "disagg4"):
        n, seed = (6, 21) if name == "disagg" else (4, 5)
        rng = np.random.default_rng(seed)
        return [(i, rng.integers(0, 256, int(rng.integers(10, 33))
                                 ).astype(np.int32), int(rng.integers(2, 7)))
                for i in range(n)]
    if name == "unified":
        rng = np.random.default_rng(12)
        return [(0, rng.integers(0, 256, 20).astype(np.int32), 6),
                (1, rng.integers(0, 256, 5).astype(np.int32), 3),
                (2, rng.integers(0, 256, 33).astype(np.int32), 4)]
    if name == "stream":
        rng = np.random.default_rng(13)
        return [(i, rng.integers(0, 256, int(rng.integers(10, 30))
                                 ).astype(np.int32), int(rng.integers(1, 7)))
                for i in range(4)]
    if name == "long37":
        return [(0, np.random.default_rng(14).integers(0, 256, 37)
                 .astype(np.int32), 5)]
    if name == "backpressure":
        rng = np.random.default_rng(15)
        return [(i, rng.integers(0, 256, 20).astype(np.int32), 4)
                for i in range(3)]
    raise KeyError(name)


# sampled requests of the "disagg" workload, (temperature, top_k, seed)
SAMPLED = {0: (1.0, 8, 42), 3: (0.7, 0, -1), 5: (2.0, 50, 2**31 - 1)}

# name -> the server and its drive: ``shards`` decode engines of
# ``decode_slots`` slots (``decode_blocks`` blocks each), a one-slot
# prefill engine under ``prefill_plan`` (chunk ``prefill_chunk``); faults
# are (step, method, argument) calls on the server before that step
SCENARIOS = {
    "two_shards": dict(shards=2),
    "one_shard": dict(shards=1),
    "retire": dict(shards=2, retire_after=3),
    "corrupt_wire": dict(shards=2, inject=("inject_handoff_corruption",)),
    "handoff_loss": dict(shards=2, inject=("inject_handoff_loss",)),
    "backpressure": dict(shards=2, decode_blocks=MAX_LEN // BLOCK,
                         requests="disagg4"),
    "mpai_prefill": dict(shards=2, prefill_plan="mpai"),
    "sampled": dict(shards=2, sampled=True),
    # the upset's eviction comes back through the seam under the prefill
    # stage's plan ("mpai"), never the shard's own (bf16)
    "hardened_bitflip": dict(shards=2, prefill_plan="mpai", harden=True,
                             sampled=True, faults=((2, "arm_bitflip", 3),)),
    "hardened_bitflip_bf16": dict(shards=2, harden=True,
                                  faults=((3, "arm_bitflip", 11),)),
    "digest_mismatch": dict(shards=2, harden=True, tamper=True),
    # one decode engine (tests/test_serve_engine.py)
    "split_unified": dict(shards=1, requests="unified"),
    "split_stream": dict(shards=1, requests="stream"),
    "split_wide": dict(shards=1, requests="long37", prefill_chunk=40),
    "split_narrow": dict(shards=1, requests="long37"),
    "split_backpressure": dict(shards=1, decode_blocks=MAX_LEN // BLOCK,
                               requests="backpressure"),
}
# the scenarios whose tokens must equal a unified bf16 engine's
UNIFIED = ("two_shards", "one_shard", "retire", "corrupt_wire",
           "handoff_loss", "split_unified", "split_stream", "split_wide",
           "split_narrow", "split_backpressure", "hardened_bitflip_bf16",
           "digest_mismatch")


def _seam_requests():
    rng = np.random.default_rng(31)
    return [(i, rng.integers(0, 256, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(5, 6), (19, 4), (30, 5)])]


def _books(eng):
    return {"num_blocks": eng.alloc.num_blocks,
            "free": [int(b) for b in eng.alloc.free],
            "quarantined": sorted(int(b) for b in eng.alloc.quarantined),
            "digests": sorted([int(b), int(d)] for b, d in
                              eng.digests.items()),
            "table": eng.table.tolist(), "lengths": eng.lengths.tolist()}


def _drive(pkg, sc: dict) -> dict:
    """Serve scenario ``sc`` through ``pkg``'s ``CoProcServer`` to the end;
    what the comparison reads."""
    make, Server, Req, Sampling, plan_of = pkg
    hk = dict(harden=True, watchdog_steps=3) if sc.get("harden") else {}
    geom = dict(prompt_len=PROMPT_LEN, max_len=MAX_LEN, block_size=BLOCK)
    pre = make(max_slots=1, plan=plan_of(sc.get("prefill_plan")),
               prefill_chunk=sc.get("prefill_chunk"), **geom, **hk)
    decs = [make(max_slots=2, num_blocks=sc.get("decode_blocks"), **geom,
                 **hk) for _ in range(sc["shards"])]
    co = Server(pre, decs)
    if sc.get("tamper"):
        # the first handoff's first digest is off by one bit after the
        # wire: the frame is intact, the import's verify fails
        real, seen = co._transport, []

        def transport(ho):
            ho = real(ho)
            if not seen:
                ho.digests = (ho.digests[0] ^ 1,) + tuple(ho.digests[1:])
            seen.append(ho.rid)
            return ho
        co._transport = transport
    events = []
    co.on_token = lambda rid, tok: events.append([int(rid), int(tok)])
    for method in sc.get("inject", ()):
        getattr(co, method)()
    trace = _requests(sc.get("requests", "disagg"))
    for rid, prompt, max_new in trace:
        sp = (Sampling(*SAMPLED[rid][:2], seed=SAMPLED[rid][2])
              if sc.get("sampled") and rid in SAMPLED else None)
        co.submit(Req(rid, prompt, max_new=max_new, sampling=sp))
    steps, retired_at = 0, None
    while co.pending:
        for at, method, arg in sc.get("faults", ()):
            if at == steps:
                getattr(co, method)(arg)
        if steps == sc.get("retire_after"):
            retired_at = co.stats()["imports_by_shard"]["shard1"]
            co.retire_shard(1)
        co.step()
        steps += 1
        assert steps < 1000, "server made no progress"
    st = co.stats()
    return {"outputs": {str(rid): co.done[rid].output.tolist()
                        for rid, _, _ in trace},
            "events": events,
            "stats": {k: v for k, v in st.items() if k not in TIMING},
            "retired_at": retired_at, "steps": steps,
            "books": [_books(e) for e in [co.prefill] + co.decodes]}


def _unified(pkg, name: str) -> dict:
    """A unified bf16 engine's tokens for workload ``name``."""
    make = pkg[0]
    eng = make(max_slots=4, prompt_len=PROMPT_LEN, max_len=MAX_LEN,
               block_size=BLOCK, plan=None)
    trace = _requests(name)
    for rid, prompt, max_new in trace:
        eng.submit(pkg[2](rid, prompt, max_new=max_new))
    while eng.pending:
        eng.step()
    return {str(rid): eng.done[rid].output.tolist() for rid, _, _ in trace}


def _seam_import(make, Req, frames) -> dict:
    """Import wire ``frames`` (by rid) into a fresh bf16 decode engine and
    decode them; ``{rid: tokens}``."""
    eng = make(max_slots=3, prompt_len=PROMPT_LEN, max_len=MAX_LEN,
               block_size=BLOCK, plan=None)
    out = {}
    for rid, prompt, max_new in _seam_requests():
        done = eng.import_prefill(Req(rid, prompt, max_new=max_new),
                                  frames[rid])
        if done is not None:
            out[str(rid)] = done.output.tolist()
    while eng.pending:
        eng.step()
    out.update({str(r.rid): r.output.tolist() for r in eng.done.values()})
    return out


def _seam_frames(make, Req) -> dict:
    """Wire frames of the seam requests from a fresh bf16 prefill
    engine."""
    pre = make(max_slots=1, prompt_len=PROMPT_LEN, max_len=MAX_LEN,
               block_size=BLOCK, plan=None)
    return {rid: pre.prefill_handoff(Req(rid, p, max_new=m)).to_bytes()
            for rid, p, m in _seam_requests()}


def _tree(flat):
    tree = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _port_pkg(params, device="cpu", server=CoProcServer):
    """The port's side of ``_drive``: engines of ``TINY`` over ``params``
    on ``device``, served by ``server(prefill, decodes)``."""
    mpai = tqat.serve_plan(TPlan.mpai(TINY.num_layers))
    return (functools.partial(ContinuousBatchingEngine, params, TINY,
                              device=device),
            server, Request, SamplingParams,
            lambda name: mpai if name == "mpai" else None)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_disagg.py OUT_DIR``
# ---------------------------------------------------------------------------
def _reference(out):
    import jax
    # synchronous dispatch: the reference's replay loop writes the next
    # token into a host array a queued decode call may still read
    # (ROADMAP §3)
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as JT
    from repro.runtime import serve as js
    from repro.runtime.sampling import SamplingParams as JS
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    out = Path(out)
    cfg = tiny_dense()
    params = JT.model_init(jax.random.PRNGKey(0), cfg)
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(out / "params.npz", **flat)
    mpai = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    pkg = (functools.partial(js.ContinuousBatchingEngine, params, cfg),
           js.CoProcServer, js.Request, JS,
           lambda name: mpai if name == "mpai" else None)
    res = {"scenarios": {name: _drive(pkg, sc)
                         for name, sc in SCENARIOS.items()},
           "unified": {name: _unified(pkg, name)
                       for name in ("disagg", "unified", "stream", "long37",
                                    "backpressure")}}
    # the cross-package seam: the reference's frames on its own decode
    # engine, and the port's frames (made here with the same weights) on
    # the reference's decode engine
    port = _port_pkg(bridge.to_torch(_tree(flat), "cpu"))
    ref_frames = _seam_frames(pkg[0], js.Request)
    port_frames = _seam_frames(port[0], Request)
    parse = js.PrefillHandoff.from_bytes
    res["seam"] = {
        "ref_on_ref": _seam_import(pkg[0], js.Request,
                                   {r: parse(f) for r, f in
                                    ref_frames.items()}),
        "port_on_ref": _seam_import(pkg[0], js.Request,
                                    {r: parse(f) for r, f in
                                     port_frames.items()})}
    np.savez(out / "frames.npz",
             **{str(r): np.frombuffer(f, np.uint8)
                for r, f in ref_frames.items()})
    (out / "ref.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("disagg_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(d)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    params = bridge.to_torch(_tree(dict(np.load(d / "params.npz"))), "cpu")
    frames = {int(r): a.tobytes() for r, a in np.load(d / "frames.npz").items()}
    return json.loads((d / "ref.json").read_text()), params, frames


# ---------------------------------------------------------------------------
# wire format, in one process
# ---------------------------------------------------------------------------
def _np_dtype(name: str):
    import ml_dtypes
    return (np.dtype(getattr(ml_dtypes, name)) if hasattr(ml_dtypes, name)
            and not hasattr(np, name) else np.dtype(name))


def _synthetic(dtype: str, n_blocks: int, digests=None, rid=7):
    """One handoff's content as numpy arrays (engine-shaped KV
    ``[n_super, n_blocks, P, KVp, hd]``, synthetic values): ``(fields,
    kv)``."""
    rng = np.random.default_rng(n_blocks)
    kv = {}
    for key in ("blk0.attn", "blk1.attn"):
        k, v = (rng.standard_normal((2, n_blocks, BLOCK, 2, 4)) * 4
                for _ in range(2))
        kv[key] = (k.astype(_np_dtype(dtype)), v.astype(_np_dtype(dtype)))
    return (dict(rid=rid, first_token=42, length=n_blocks * BLOCK,
                 block_size=BLOCK, digests=digests), kv)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes' included) as a torch tensor, same bits."""
    name = a.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        raw = torch.from_numpy(a.view(np.int16 if name == "bfloat16"
                                      else np.uint8).copy())
        return raw.view(getattr(torch, name))
    return torch.from_numpy(a.copy())


def _raw(t) -> bytes:
    t = t.detach().cpu().contiguous() if isinstance(t, torch.Tensor) \
        else torch.as_tensor(np.asarray(t).view(np.uint8))
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _port_handoff(dtype, n_blocks, digests=None):
    fields, kv = _synthetic(dtype, n_blocks, digests)
    return PrefillHandoff(kv={k: (_torch(a), _torch(b))
                              for k, (a, b) in kv.items()}, **fields)


DIGESTS = {"none": None, "set": (0, 1, 2**31, 0xFFFFFFFF)}


@pytest.mark.parametrize("digests", sorted(DIGESTS))
@pytest.mark.parametrize("n_blocks", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_wire_round_trip_is_bit_exact(dtype, n_blocks, digests):
    ho = _port_handoff(dtype, n_blocks, DIGESTS[digests])
    wire = ho.to_bytes()
    back = PrefillHandoff.from_bytes(wire)
    assert (back.rid, back.first_token, back.length, back.block_size,
            back.digests) == (ho.rid, ho.first_token, ho.length,
                              ho.block_size, ho.digests)
    assert isinstance(back.first_token, int)
    assert sorted(back.kv) == sorted(ho.kv)
    for key in ho.kv:
        for a, b in zip(ho.kv[key], back.kv[key]):
            assert b.dtype == a.dtype and b.shape == a.shape
            assert b.device.type == "cpu"
            assert _raw(b) == _raw(a)
    assert back.to_bytes() == wire


@pytest.mark.parametrize("digests", sorted(DIGESTS))
@pytest.mark.parametrize("n_blocks", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "float8_e4m3fn", "float8_e5m2", "int8",
                                   "int32"])
def test_wire_bytes_equal_the_references(dtype, n_blocks, digests):
    """The same content serializes to the same frame in both packages, and
    each package parses the other's frame into the same arrays."""
    from repro.runtime.serve import PrefillHandoff as JHandoff
    fields, kv = _synthetic(dtype, n_blocks, DIGESTS[digests])
    want = JHandoff(kv=kv, **fields).to_bytes()
    port = _port_handoff(dtype, n_blocks, DIGESTS[digests])
    assert port.to_bytes() == want
    theirs = JHandoff.from_bytes(port.to_bytes())
    ours = PrefillHandoff.from_bytes(want)
    assert ours.digests == theirs.digests == fields["digests"]
    for key in kv:
        for a, b, c in zip(kv[key], ours.kv[key], theirs.kv[key]):
            assert _raw(b) == np.ascontiguousarray(a).tobytes() \
                == np.asarray(c).tobytes()
            assert tuple(b.shape) == a.shape == np.asarray(c).shape
            assert np.asarray(c).dtype == a.dtype
    assert ours.to_bytes() == want


def test_wire_rejects_truncation_at_every_boundary():
    wire = _port_handoff("float32", 2).to_bytes()
    for cut in range(len(wire)):
        with pytest.raises(HandoffWireError):
            PrefillHandoff.from_bytes(wire[:cut])
    with pytest.raises(HandoffWireError):             # overlong
        PrefillHandoff.from_bytes(wire + b"\x00")


def test_wire_rejects_version_mismatch_and_bad_magic():
    wire = bytearray(_port_handoff("float32", 1).to_bytes())
    struct.pack_into("<H", wire, 4, WIRE_VERSION + 1)
    with pytest.raises(HandoffWireError, match="version"):
        PrefillHandoff.from_bytes(bytes(wire))
    wire = b"NOPE" + _port_handoff("float32", 1).to_bytes()[4:]
    with pytest.raises(HandoffWireError, match="magic"):
        PrefillHandoff.from_bytes(wire)


def test_wire_payload_flip_is_corruption_not_wire_error():
    """An upset anywhere in the payload of an intact frame is the
    retryable failure."""
    wire = _port_handoff("float32", 2).to_bytes()
    for pos in range(18, len(wire), 5):
        for bit in (0x01, 0x10, 0x80):
            bad = wire[:pos] + bytes([wire[pos] ^ bit]) + wire[pos + 1:]
            with pytest.raises(HandoffCorruptError):
                PrefillHandoff.from_bytes(bad)


def _renamed(wire: bytes, old: bytes, new: bytes) -> bytes:
    """``wire`` with every dtype name ``old`` replaced by ``new`` (same
    length) and its checksum made good again."""
    assert len(old) == len(new)
    payload = wire[18:].replace(old, new)
    return wire[:6] + struct.pack("<QI", len(payload),
                                  paging.wire_checksum(payload)) + payload


def test_wire_rejects_an_unknown_dtype():
    from repro.runtime.serve import HandoffWireError as JWireError
    from repro.runtime.serve import PrefillHandoff as JHandoff
    wire = _renamed(_port_handoff("float32", 1).to_bytes(), b"float32",
                    b"floatXX")
    with pytest.raises(HandoffWireError, match="dtype"):
        PrefillHandoff.from_bytes(wire)
    with pytest.raises(JWireError, match="dtype"):
        JHandoff.from_bytes(wire)
    # a name numpy knows but the port's pools never hold
    wire = _renamed(_port_handoff("float32", 1).to_bytes(), b"float32",
                    b"float96")
    with pytest.raises(HandoffWireError, match="dtype"):
        PrefillHandoff.from_bytes(wire)


# ---------------------------------------------------------------------------
# the cross-package seam
# ---------------------------------------------------------------------------
def _near_tie_equal(params, got: dict, want: dict, what: str) -> None:
    """Greedy streams equal, or parting first at a near-tie (within 4 bf16
    ulps of the top logit) of the port's top two logits over the padded
    prompt and the tokens before it."""
    for rid, prompt, _ in _seam_requests():
        a, b = got[str(rid)], want[str(rid)]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.zeros(-(-max(len(prompt), PROMPT_LEN) // PROMPT_LEN)
                       * PROMPT_LEN, np.int32)
        ctx[-len(prompt):] = prompt
        ctx = np.concatenate([ctx, np.asarray(b[:t], np.int32)])
        top2 = torch.topk(T.forward(params, TINY, torch.as_tensor(ctx[None])
                                    ).logits[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        assert margin <= 2 ** -5 * abs(float(top2[0])), (
            f"{what}: request {rid} parts at token {t} ({a[t]} vs {b[t]}) "
            f"with top-2 margin {margin}")


def test_reference_frames_decode_on_the_port(ref):
    want, params, frames = ref
    port = _port_pkg(params)
    got = _seam_import(port[0], Request,
                       {r: PrefillHandoff.from_bytes(f)
                        for r, f in frames.items()})
    assert {k: len(v) for k, v in got.items()} == \
        {str(r): m for r, _, m in _seam_requests()}
    _near_tie_equal(params, got, want["seam"]["ref_on_ref"],
                    "reference frames on the port")


def test_port_frames_decode_on_the_reference(ref):
    """The reference's decode engine, given the port's frames, decodes
    what the port's own decode engine does with them."""
    want, params, _ = ref
    port = _port_pkg(params)
    frames = _seam_frames(port[0], Request)
    got = _seam_import(port[0], Request,
                       {r: PrefillHandoff.from_bytes(f)
                        for r, f in frames.items()})
    _near_tie_equal(params, got, want["seam"]["port_on_ref"],
                    "port frames on the reference")


def test_engine_frames_have_the_references_layout(ref):
    """The port's frame of a seam request has the reference's header,
    fields, keys, dtypes and shapes (its KV bits may part where the two
    packages round differently)."""
    _, params, frames = ref
    ours = _seam_frames(_port_pkg(params)[0], Request)
    for rid, wire in frames.items():
        a, b = PrefillHandoff.from_bytes(ours[rid]), \
            PrefillHandoff.from_bytes(wire)
        assert len(ours[rid]) == len(wire)
        assert (a.rid, a.first_token, a.length, a.block_size, a.digests) \
            == (b.rid, b.first_token, b.length, b.block_size, b.digests)
        assert sorted(a.kv) == sorted(b.kv)
        for key in a.kv:
            for x, y in zip(a.kv[key], b.kv[key]):
                assert x.dtype == y.dtype and x.shape == y.shape


# ---------------------------------------------------------------------------
# CoProcServer against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(ref):
    pkg = _port_pkg(ref[1])
    return {name: _drive(pkg, sc) for name, sc in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_coproc_server_equals_the_reference(ref, served, name):
    want, got = ref[0]["scenarios"][name], served[name]
    assert got["outputs"] == want["outputs"], (
        "streams differ: check the reference's top-2 margin at the first "
        "divergent token (ROADMAP, 'Greedy near-ties')")
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
    assert got["books"] == want["books"]
    assert (got["retired_at"], got["steps"]) == (want["retired_at"],
                                                 want["steps"])
    # every token streams exactly once, in order
    for rid, out in got["outputs"].items():
        assert [t for r, t in got["events"] if r == int(rid)] == out
    trace = _requests(SCENARIOS[name].get("requests", "disagg"))
    for rid, _, max_new in trace:
        assert len(got["outputs"][str(rid)]) == max_new


@pytest.mark.parametrize("name", UNIFIED)
def test_bf16_split_equals_the_unified_engine(ref, served, name):
    """The reference's claim, on the port: bf16 shards decode what one
    unified bf16 engine does, through loss, corruption, retirement,
    backpressure and a restored bit flip."""
    wl = SCENARIOS[name].get("requests", "disagg")
    want = ref[0]["unified"][wl]
    assert served[name]["outputs"] == want
    assert _unified(_port_pkg(ref[1]), wl) == want


def test_scenarios_exercise_what_they_claim(ref, served):
    st = {name: r["stats"] for name, r in served.items()}
    two = st["two_shards"]
    assert two["decode_shards"] == 2 and two["handoffs"] == 6
    assert all(v > 0 for v in two["imports_by_shard"].values())
    assert st["one_shard"]["imports_by_shard"] == {"shard0": 6}
    assert served["retire"]["retired_at"] > 0
    assert st["retire"]["imports_by_shard"]["shard1"] == \
        served["retire"]["retired_at"]
    assert (st["corrupt_wire"]["handoffs_replayed"],
            st["corrupt_wire"]["handoffs_lost"]) == (1, 0)
    assert (st["handoff_loss"]["handoffs_replayed"],
            st["handoff_loss"]["handoffs_lost"]) == (1, 1)
    assert st["digest_mismatch"]["handoffs_replayed"] == 1
    for name in ("hardened_bitflip", "hardened_bitflip_bf16"):
        s = st[name]
        assert s["bitflips_detected"] >= 1 and s["blocks_quarantined"] >= 1
        assert s["replays"] >= 1
        for books in served[name]["books"]:
            assert len(books["free"]) + len(books["quarantined"]) == \
                books["num_blocks"]
    assert served["sampled"]["outputs"] != served["two_shards"]["outputs"]
    assert served["mpai_prefill"]["outputs"] != \
        served["two_shards"]["outputs"]
    assert st["split_backpressure"]["deferrals"] > 0
    assert served["split_wide"]["outputs"] == \
        served["split_narrow"]["outputs"]


@pytest.mark.parametrize("name", ["backpressure", "split_backpressure"])
def test_backpressure_parks_without_a_second_prefill(served, name):
    """Deferral parks the wire frame: every prompt is prefilled once, and
    every shard's blocks come back."""
    trace = _requests(SCENARIOS[name]["requests"])
    st = served[name]["stats"]
    assert st["prefill_tokens"] == sum(
        -(-len(p) // PROMPT_LEN) * PROMPT_LEN for _, p, _ in trace)
    for books in served[name]["books"]:
        assert len(books["free"]) == books["num_blocks"]


def test_bad_retires_raise(ref):
    make = _port_pkg(ref[1])[0]
    geom = dict(prompt_len=PROMPT_LEN, max_len=MAX_LEN, block_size=BLOCK)
    co = CoProcServer(make(max_slots=1, **geom),
                      [make(max_slots=2, **geom) for _ in range(2)])
    co.retire_shard(1)
    with pytest.raises(ValueError):
        co.retire_shard(0)
    with pytest.raises(IndexError):
        co.retire_shard(5)
    assert co._import_order() == [0]


def test_shards_never_restore_themselves(ref, served):
    """A decode shard's evictions wait for the seam: ``step`` and
    ``scrub`` leave its restore queue alone while ``external_restore``
    is set."""
    eng = ContinuousBatchingEngine(ref[1], TINY, max_slots=2,
                                   prompt_len=PROMPT_LEN, max_len=MAX_LEN,
                                   block_size=BLOCK, harden=True,
                                   device="cpu")
    eng.external_restore = True
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), max_new=12))
    for _ in range(3):
        eng.step()
    eng.arm_bitflip(0)
    eng.step()
    assert eng.bitflips_detected == 1 and len(eng._restore_queue) == 1
    eng.step()
    eng.scrub(100)
    assert len(eng._restore_queue) == 1 and eng.replays == 0


if __name__ == "__main__":
    _reference(sys.argv[1])
