"""Asynchronous, crash-consistent checkpointing, in the JAX package's
on-disk format (`repro/checkpoint/checkpointer.py`).

  - a tree of nested dicts, lists, tuples and NamedTuples is flattened to
    key paths and saved as one ``leaf_%05d.npy`` per leaf inside a step
    directory (``step_00000042/``), plus a ``manifest.json`` with the
    step, a ``treedef`` description and each leaf's file, shape and
    dtype. Keys are the path's parts joined by ``::``; dict keys go in
    sorted order, which is the order `jax.tree_util` flattens dicts in, so
    the two packages number the same leaves the same way;
  - writes go to ``step_X.tmp/`` and are renamed after an fsync, so a
    killed run never leaves a half-written step that `latest_step` would
    pick;
  - an async writer thread takes the IO off the caller
    (``save(..., blocking=False)``); its failure is raised on the next
    `save` or `wait`;
  - dtypes outside the JAX package's native list (bfloat16, float16, fp8)
    are saved as raw unsigned bits under their logical name. numpy has no
    bfloat16, so `restore_dict` returns such a leaf as a torch tensor
    viewed from the raw bits (``torch.bfloat16``).

Leaves may be torch tensors (on any device: saved from host copies taken
at `save` time) or numpy arrays. ``treedef`` describes the tree in the
form of JAX's ``str(treedef)`` for dict, list and tuple trees; nothing
reads it back.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

Tree = Any

_SEP = "::"

#: dtypes saved as themselves; every other dtype is saved as raw bits
_NATIVE = ("float32", "float64", "int32", "int64", "uint32", "bool", "int8",
           "uint8", "int16")


def _children(tree):
    """``[(path part, subtree), ...]`` in flattening order, or None for a
    leaf. None is an empty subtree, as in `jax.tree_util`."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _leaves(tree, prefix: tuple = ()):
    """``(key, leaf)`` pairs in `jax.tree_util` flattening order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield _SEP.join(str(p) for p in prefix), tree
        return
    for part, sub in kids:
        yield from _leaves(sub, prefix + (part,))


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_describe(v) for v in tree) + "])")
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_describe(v) for v in tree) + (
            ",)" if len(tree) == 1 else ")")
    return "*"


def _treedef(tree) -> str:
    return f"PyTreeDef({_describe(tree)})"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (host array to save, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        logical = str(t.dtype).removeprefix("torch.")
        if logical == "bool" or not (t.dtype.is_floating_point
                                     or t.dtype.is_complex) \
                or logical in ("float16", "float32", "float64"):
            return t.numpy().copy(), logical
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        raw = t.view(bits).numpy()
        return raw.view(np.dtype(f"u{t.element_size()}")).copy(), logical
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, logical: str):
    """Undo the raw-bit round trip: a numpy array of the logical dtype,
    or a torch tensor where numpy has no such dtype (bfloat16, fp8)."""
    if str(arr.dtype) == logical:
        return arr
    try:
        dt = np.dtype(logical)
    except TypeError:
        dt = None
    if dt is not None and dt.kind != "V":  # a dtype numpy has of its own
        return arr.view(dt)
    tdt = getattr(torch, logical, None)
    if not isinstance(tdt, torch.dtype):
        raise ValueError(f"checkpoint leaf of unknown dtype {logical!r}")
    signed = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
    return torch.from_numpy(arr.view(signed[arr.dtype.itemsize])).view(tdt)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- paths ----
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def latest_step(self) -> int | None:
        """The newest complete step: a ``.tmp`` directory or one without
        its manifest never counts."""
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp") and (p / "manifest.json").exists())
        return steps[-1] if steps else None

    # ---- save ----
    def save(self, step: int, tree: Tree, *, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``: now, or on the writer thread
        (``blocking=False``). The leaves are copied to host memory here,
        so the caller may change them as soon as this returns."""
        # a failed async write must not be dropped: raise it on the NEXT
        # save (or wait), not never
        self._raise_pending()
        flat = {key: _host(leaf) for key, leaf in _leaves(tree)}
        treedef = _treedef(tree)
        if blocking:
            self._write(step, flat, treedef)
        else:
            self._ensure_worker()
            self._q.put((step, flat, treedef))

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # raised by the next save() or wait()
                self._error = e

    def wait(self) -> None:
        """Block until queued async saves are durable."""
        if self._worker and self._worker.is_alive():
            self._q.put(None)
            self._worker.join()
            self._worker = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        """Re-raise the writer thread's failure recorded by `_drain`, so an
        async checkpoint that never reached the disk is reported on the next
        checkpoint call (a restart would otherwise resume from a stale
        step)."""
        if self._error:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, flat: dict, treedef: str) -> None:
        final = self._step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": treedef, "leaves": {}}
        for i, (key, (arr, logical)) in enumerate(flat.items()):
            fname = f"leaf_{i:05d}.npy"
            if logical not in _NATIVE and str(arr.dtype) == logical:
                arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": logical}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----
    def _load(self, step: int) -> tuple[dict, pathlib.Path]:
        d = self._step_dir(step)
        return json.loads((d / "manifest.json").read_text()), d

    def restore(self, step: int, like: Tree) -> Tree:
        """Restore into the structure of ``like`` (its values are ignored):
        a leaf that is a tensor in ``like`` comes back as a tensor on that
        tensor's device, any other leaf as a numpy array (or a tensor where
        numpy has no such dtype)."""
        manifest, d = self._load(step)
        leaves = iter(_leaves(like))

        def rebuild(node, prefix):
            if node is None:
                return None
            kids = _children(node)
            if kids is None:
                key, leaf = next(leaves)
                info = manifest["leaves"][key]
                arr = _from_saved(np.load(d / info["file"]), info["dtype"])
                if isinstance(leaf, torch.Tensor):
                    arr = torch.as_tensor(arr).to(leaf.device)
                return arr
            vals = {part: rebuild(sub, prefix + (part,))
                    for part, sub in kids}
            if isinstance(node, dict):
                return {k: vals[k] for k in node}
            if hasattr(node, "_fields"):
                return type(node)(**vals)
            return type(node)(vals[i] for i in range(len(node)))

        return rebuild(like, ())

    def restore_dict(self, step: int) -> dict:
        """Restore a checkpoint saved from (nested) string-keyed dicts into
        plain nested dicts, with no ``like`` tree: the manifest alone drives
        the load. This is the service-snapshot path
        (`repro_torch.serve.snapshot`): a restarting process has nothing to
        build a ``like`` tree from until it has read the checkpoint. Leaves
        are host numpy arrays, or CPU tensors where numpy has no such dtype
        (bfloat16)."""
        manifest, d = self._load(step)
        out: dict = {}
        for key, info in manifest["leaves"].items():
            arr = _from_saved(np.load(d / info["file"]), info["dtype"])
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        return out
