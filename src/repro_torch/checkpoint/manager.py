"""Checkpoint manager: async save, atomic commit, keep-last-K (the port of
``repro.checkpoint.manager``, same on-disk layout, so either package reads
the other's checkpoints).

Layout (one directory per step):
    ckpt_dir/step_00000123.tmp/ -> renamed to step_00000123/ on commit
        arrays.npz        flat {path: np.ndarray} of params + opt state
        manifest.json     step, number of arrays, time

Keys are the reference's ``jax.tree_util`` paths joined by ``/``: a named
tuple's field as ``.name``, a dict key as itself, a sequence index as its
number (``.params/layers/sub_0/mlp/w_in``, ``.opt/.mu/embed``,
``.opt/.count``, ``.step``).  bf16 leaves are stored as 2-byte voids, as
numpy stores ``ml_dtypes.bfloat16``.

A save snapshots the tree to host memory synchronously and writes it from
a background thread (training never blocks on storage); commit is the
atomic directory rename, so a crash mid-save leaves only a .tmp that
restore ignores.  Restore rebuilds a tree like the one it is given (the
state's ``meta`` tensors serve) on the device it is asked for, each array
through ``bridge.to_tensor``.

A state sharded over a mesh (``shardings``, a ``sharding.TreeSharding``)
is saved whole: every rank gathers each leaf, rank 0 alone writes the same
``arrays.npz``, and every rank waits for the commit at the next ``wait``.
Restore maps each stored array in place and reads, with ``shardings``,
only each rank's part of each whole array, so a checkpoint written on any
mesh (one device included) restores on any other, bit for bit — the
counterpart of the reference's ``restore(..., shardings=)``, the
elastic-restart path.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge


def _items(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts, named tuples and sequences;
    paths as the reference's checkpoint keys."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, fn, prefix=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, fn, prefix + ("." + name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # a copy, also of a CPU tensor: the trainer updates its state in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype.kind == "V":
        a = a.view(np.int16)
        return bridge.to_tensor(a, "cpu").view(torch.bfloat16).to(device)
    return bridge.to_tensor(a, device).to(like.dtype)


_NPY_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}


def _stored_arrays(path: str) -> dict:
    """``{key: read-only np.memmap}`` of an ``np.savez`` archive (stored,
    not compressed): each member's ``.npy`` data mapped where it lies, so a
    restore reads only the bytes it keeps, once, with no pass over the
    whole archive."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset + 26)     # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version not in _NPY_HEADER:
                raise ValueError(f"{path}: {info.filename} is .npy {version}")
            shape, fortran, dtype = _NPY_HEADER[version](f)
            key = info.filename[:-len(".npy")]
            out[key] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                                 shape=shape, order="F" if fortran else "C")
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = None          # the shardings of a save in flight

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings=None) -> None:
        """Snapshot to host memory synchronously, write asynchronously.
        With ``shardings`` (collective) the whole tree is gathered and rank
        0 writes it."""
        self.wait()                                   # one in flight at a time
        if shardings is not None:
            tree = shardings.unshard(tree)
            self._pending = shardings
            if not shardings.is_writer:
                if blocking:
                    self.wait()
                return
        flat = {k: _to_numpy(v) for k, v in _items(tree)}      # D2H now

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                manifest = {"step": step, "num_arrays": len(flat),
                            "time": time.time()}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)                 # atomic commit
                self._gc()
            except BaseException as e:                # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:                 # every rank, committed
            pending, self._pending = self._pending, None
            pending.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device="cuda", shardings=None) -> Tuple[Any, int]:
        """Rebuild ``tree_like``'s structure (tensors of any device, meta
        included, giving shapes and dtypes) from disk, on ``device``; with
        ``shardings`` each leaf is this rank's part of the whole array."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        flat = _stored_arrays(os.path.join(path, "arrays.npz"))
        specs = dict(_items(shardings.specs)) if shardings else {}

        def leaf(key, like):
            arr = flat[key]
            if arr.shape != tuple(like.shape):
                raise ValueError(f"checkpoint {key}: shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            if shardings is not None:             # this rank's part alone
                arr = arr[shardings.slices(specs[key], arr.shape)]
            return _from_numpy(arr, like, device)
        return _rebuild(tree_like, leaf), step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
