"""Checkpoints with atomic writes, retention and async save (the port of
``repro/checkpoint/ckpt.py``), in ``repro``'s on-disk format, so that a
checkpoint written by either package restores in the other.

Layout:  <dir>/step_<N:08d>/
             manifest.json   — step, process_count (1), one entry per leaf
                               (path, shape, dtype name, spec) and the
                               caller's extra metadata
             arrays.npz      — the leaves keyed by path

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars; None is an empty subtree. Dict keys are visited in
sorted order and a leaf's path joins its keys and indices with "/", as
``repro`` flattens a JAX tree (``{"a": .., "nested": {"b": ..}}`` ->
``a``, ``nested/b``).

A spec is a list or tuple of axis names, one entry per dimension (None
for a dimension on no axis, a nested list or tuple for several axes):
``["data"]`` is a leaf partitioned along the axis "data", ``[]`` a
replicated one. The manifest stores it as the JSON list ``repro`` stores
for the same ``PartitionSpec``. ``specs`` mirrors the tree down to each
leaf's spec.

bfloat16 and the float8 types, which numpy cannot hold, are stored as
``uint16`` / ``uint8`` views under their logical dtype name, as ``repro``
stores them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

# dtype name -> (torch dtype, the numpy view it is stored as, the numpy
# view torch reads it back through).
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8),
}


class _HostLeaf:
    """A leaf copied to the host: its numpy array (the unsigned view for
    a type in ``_EXOTIC``) and its dtype's name."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


def _flatten(tree, keys: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(keys, leaf) pairs in ``repro``'s order: dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            keys + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, keys + (i,))]
    return [(keys, tree)]


def _path_str(keys) -> str:
    return "/".join(str(k) for k in keys)


def _spec_at(specs, keys):
    node = specs
    for k in keys:
        node = node[k]
    return node


def _spec_to_json(spec):
    return [list(p) if isinstance(p, (list, tuple)) else p for p in spec]


def _to_host(leaf) -> _HostLeaf:
    """A copy of ``leaf`` on the host: the caller may overwrite its
    tensors once this returns."""
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            _, stored, read = _EXOTIC[name]
            return _HostLeaf(t.view(getattr(torch, np.dtype(read).name))
                             .numpy().view(stored), name)
        arr = t.numpy()
        return _HostLeaf(arr, arr.dtype.name)
    arr = np.array(leaf)
    name = arr.dtype.name
    if name in _EXOTIC:
        arr = arr.view(_EXOTIC[name][1])
    return _HostLeaf(arr, name)


def _host_tree(tree):
    """``tree`` with every leaf replaced by its host copy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _to_host(tree)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _EXOTIC:
        logical, _, read = _EXOTIC[dtype]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(read)) \
            .view(logical)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def save_checkpoint(directory: str, step: int, tree: Any,
                    specs: Optional[Any] = None,
                    extra: Optional[Dict] = None) -> str:
    """Atomic save: write to a temp dir, fsync, rename."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays = {}
        manifest_leaves = []
        for keys, leaf in _flatten(tree):
            key = _path_str(keys)
            host = _to_host(leaf)
            arrays[key] = host.array
            manifest_leaves.append({
                "path": key,
                "shape": list(host.array.shape),
                "dtype": host.dtype,
                "spec": _spec_to_json(_spec_at(specs, keys))
                if specs is not None else None,
            })
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "process_count": 1,
                    "leaves": manifest_leaves, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE checkpoint step, or None.

    A ``step_<N>`` directory without a manifest.json is a partial write
    (a crash mid-copy, or a foreign tool's leftovers — the atomic
    tmp+rename save never produces one itself) and is skipped:
    restore-latest must land on a checkpoint it can read."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       tree_like: Any = None, device="cuda"):
    """Restore the checkpoint of ``step`` (the latest complete one when
    None) as tensors on ``device``: a tree shaped like ``tree_like``, or
    a flat dict keyed by path when it is None.

    ``repro``'s ``mesh=`` placement has no counterpart: the port's
    :class:`~repro_torch.core.types.SolveState` is logical (unpadded),
    and ``solve_sharded`` slices it for the process group it runs on, so
    a checkpoint restores onto any number of ranks as it is.

    Returns (tree, manifest_extra).
    """
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        by_path = {leaf["path"]: _from_host(data[leaf["path"]],
                                            leaf["dtype"], dev)
                   for leaf in manifest["leaves"]}
    if tree_like is None:
        return by_path, manifest.get("extra", {})

    def rebuild(like, keys):
        if like is None:
            return None
        if isinstance(like, dict):
            return {k: rebuild(v, keys + (k,)) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(rebuild(v, keys + (i,))
                              for i, v in enumerate(like))
        return by_path[_path_str(keys)]

    return rebuild(tree_like, ()), manifest.get("extra", {})


class CheckpointManager:
    """Retention + async save on top of save/restore.

    Use as a context manager (or call :meth:`close`) so the last async
    save thread is joined before the run exits. A save that raised in
    its thread raises again from the next :meth:`wait` (and so from
    ``save``, ``close`` and ``restore_latest``): a lost write is never
    passed over."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, specs=None, extra=None):
        # The leaves go to the host BEFORE the thread starts: the solver
        # may overwrite its tensors in place.
        host_tree = _host_tree(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, specs,
                                extra)
                self._gc()
            except BaseException as e:  # raised again by wait()
                self._error = e

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(d.split("_")[1])
                       for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def close(self):
        """Join the outstanding async save (if any). Idempotent."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def restore_latest(self, tree_like=None, device="cuda"):
        self.wait()
        return restore_checkpoint(self.directory, None, tree_like, device)
