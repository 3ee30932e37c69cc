"""Crash-safe, asynchronous checkpointing (counterpart of
``repro.train.checkpoint``).

The on-disk layout is the JAX manager's, so either package restores the
other's checkpoints: ``step-XXXXXXXXXX/`` holds ``arrays.npz`` (leaf
``i`` as ``a{i}``) and ``MANIFEST.json`` (step, time, leaf names,
dtypes, and ``extra``, e.g. the data cursor for an exact resume).
Leaves are taken in the JAX package's order and named as it names them:
dict keys sorted, list and tuple items by index, a named tuple's fields
as ``.field``; ``None`` is no leaf, a Python int a 0-d int32 array.
bfloat16 is stored as its uint16 bits with ``"bfloat16"`` in the
manifest, since numpy has no bfloat16.

* atomic: a step is written to a temp dir (arrays fsynced, the manifest
  through a temp file, fsync and ``os.replace``), renamed into place, and
  the parent dir fsynced, so a crash mid-save never leaves a partial
  ``step-*`` dir;
* async: leaves are copied to host numpy on the caller's thread, then a
  non-daemon writer thread writes them while training goes on; the next
  save, ``wait()`` or ``close()`` joins it;
* keep-k retention.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_NP_DTYPES = {torch.float32: "float32", torch.float16: "float16",
              torch.bfloat16: "bfloat16", torch.float64: "float64",
              torch.int32: "int32", torch.int64: "int64",
              torch.int16: "int16", torch.int8: "int8",
              torch.uint8: "uint8", torch.bool: "bool"}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_names(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the JAX package's leaf order and naming."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_names(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in flatten_with_names(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_names(v, join(i))]
    return [(prefix or "leaf", tree)]


def _unflatten(template: Tree, leaves) -> Tree:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A private host copy of ``leaf`` and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NP_DTYPES[t.dtype]
    arr = np.array(leaf, dtype=np.int32 if isinstance(leaf, int) else None)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like):
    """The stored array as ``like``'s kind: a tensor of its dtype on its
    device (a meta template leaf gives a CPU tensor), or a Python int."""
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    device = "cpu" if like.device.type == "meta" else like.device
    return t.to(device=device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        # host copies BEFORE the writer thread sees them, so the next
        # train step can never change what is being written
        named, dtypes = [], []
        for name, leaf in flatten_with_names(state):
            arr, dt = _to_host(leaf)
            named.append((name, arr))
            dtypes.append(dt)
        manifest = {"step": int(step), "time": time.time(),
                    "leaves": [n for n, _ in named], "dtypes": dtypes,
                    "extra": extra or {}}
        self.wait()
        if self.async_save:
            # non-daemon: the interpreter waits for it at exit instead of
            # killing it mid-write
            self._thread = threading.Thread(
                target=self._write, args=(step, named, manifest),
                daemon=False, name="ckpt-writer")
            self._thread.start()
        else:
            self._write(step, named, manifest)

    def _write(self, step: int, named, manifest) -> None:
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step-{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"a{i}": arr for i, (_, arr) in enumerate(named)})
        with open(tmp / "arrays.npz", "rb") as f:
            os.fsync(f.fileno())
        # the manifest through a temp file: a reader of the final dir
        # never sees a half-written MANIFEST.json
        mtmp = tmp / ".MANIFEST.json.tmp"
        with open(mtmp, "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, tmp / "MANIFEST.json")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        dfd = os.open(self.dir, os.O_RDONLY)   # make the rename durable
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        """Join any in-flight writer; safe to call repeatedly."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step-{s:010d}", ignore_errors=True)

    # -- load ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step-*"):
            try:
                out.append(int(p.name.split("-")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None
                ) -> Tuple[int, Tree, Dict[str, Any]]:
        """(step, state, extra): the checkpoint of ``step`` (default the
        latest) in ``template``'s structure, each leaf with its template
        leaf's dtype and device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step-{step:010d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        likes = [leaf for _, leaf in flatten_with_names(template)]
        n = len(manifest["leaves"])
        if n != len(likes):
            raise ValueError(f"checkpoint has {n} leaves, template "
                             f"{len(likes)}")
        dtypes = manifest.get("dtypes", ["float32"] * n)
        with np.load(d / "arrays.npz", allow_pickle=False) as z:
            leaves = [_from_host(z[f"a{i}"], dtypes[i], like)
                      for i, like in enumerate(likes)]
        return step, _unflatten(template, iter(leaves)), manifest["extra"]
