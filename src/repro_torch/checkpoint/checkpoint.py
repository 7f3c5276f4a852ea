"""Fault-tolerant checkpointing: one ``.npy`` per leaf + manifest, atomic
rename.

A copy of ``repro/checkpoint/checkpoint.py``, on the same layout::

    <dir>/step-000123/
        manifest.json         # leaf names, shapes, dtypes
        leaf-00000.npy ...    # one file per tree leaf
        _COMPLETE             # written last; restore requires it

A tree is a nested dict (a ``NamedTuple`` such as ``AdamWState`` counts
as the dict of its fields) whose leaves are tensors, numpy arrays or
ints, flattened in sorted-key order; the manifest records each leaf's
dotted name beside its shape and dtype, and a restore checks both.
Atomicity: everything is written into ``.tmp-step-...`` then renamed --
a crashed save can never be mistaken for a restorable step.
``CheckpointManager`` adds retention, latest-step discovery, and an
async mode that stages the tree in host memory and writes it on a
background thread; its staging buffer is a DynIMS-managed store, so a
memory burst in the training process shrinks checkpoint staging
before it causes pressure.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.store import EvictionReport
from ..device import DeviceLike, resolve_device

_STEP_RE = re.compile(r"^step-(\d{9})$")


def _fields(node) -> Optional[Mapping]:
    """A node's children by key, or None for a leaf."""
    if isinstance(node, Mapping):
        return node
    if isinstance(node, tuple) and hasattr(node, "_asdict"):
        return node._asdict()
    return None


def flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(dotted name, leaf) pairs in sorted-key order."""
    children = _fields(tree)
    if children is None:
        return [(prefix[:-1], tree)]
    out = []
    for key in sorted(children):
        out += flatten(children[key], f"{prefix}{key}.")
    return out


def _unflatten(tree_like, leaves: dict, prefix: str = ""):
    children = _fields(tree_like)
    if children is None:
        return leaves[prefix[:-1]]
    rebuilt = {k: _unflatten(v, leaves, f"{prefix}{k}.")
               for k, v in children.items()}
    if isinstance(tree_like, Mapping):
        return rebuilt
    return type(tree_like)(**rebuilt)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _staged(leaf):
    """A leaf's host copy (never a view of a CPU tensor's memory)."""
    if isinstance(leaf, int):
        return leaf
    arr = _host(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return arr
    return np.array(arr)


def save_pytree(tree, directory: str, step: int) -> str:
    """Atomic save; returns the final step directory."""
    final = os.path.join(directory, f"step-{step:09d}")
    tmp = os.path.join(directory, f".tmp-step-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    named = [(name, _host(x)) for name, x in flatten(tree)]
    manifest = {
        "step": step,
        "n_leaves": len(named),
        "leaves": [{"name": n, "shape": list(x.shape), "dtype": str(x.dtype)}
                   for n, x in named],
    }
    for i, (_, arr) in enumerate(named):
        np.save(os.path.join(tmp, f"leaf-{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as fh:
        fh.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore_pytree(tree_like, directory: str, step: int, *,
                   device: DeviceLike = None):
    """Restore into the structure of ``tree_like`` (names and shapes
    checked).  A tensor leaf comes back as a tensor on ``device`` (the
    card by default), an int leaf as an int, any other as numpy."""
    path = os.path.join(directory, f"step-{step:09d}")
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"no complete checkpoint at {path}")
    dev = resolve_device(device)
    named = flatten(tree_like)
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    if manifest["n_leaves"] != len(named):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"model expects {len(named)}")
    leaves = {}
    for i, ((name, ref), rec) in enumerate(zip(named, manifest["leaves"])):
        if rec["name"] != name:
            raise ValueError(f"leaf {i}: checkpoint holds {rec['name']!r} "
                             f"where the tree has {name!r}")
        arr = np.load(os.path.join(path, f"leaf-{i:05d}.npy"))
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(
                f"leaf {i} ({name}): checkpoint shape {arr.shape} != "
                f"model shape {tuple(np.shape(ref))}")
        if isinstance(ref, torch.Tensor):
            leaves[name] = torch.from_numpy(arr).to(dev)
        elif isinstance(ref, int):
            leaves[name] = int(arr)
        else:
            leaves[name] = arr
    return _unflatten(tree_like, leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "_COMPLETE")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """Retention + async host-staged saves with a managed staging buffer."""

    name = "ckpt-staging"
    priority = 5               # above dataset cache, below compute

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._staged_bytes = 0.0           # guarded-by: _lock
        self._capacity = float("inf")      # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- ManagedStore interface (staging buffer under DynIMS) ---------------
    def capacity(self) -> float:
        return self._capacity if self._capacity != float("inf") else 0.0

    def used(self) -> float:
        return self._staged_bytes

    def set_capacity(self, capacity: float):
        with self._lock:
            self._capacity = capacity
            over = self._staged_bytes > capacity
        # A shrink below current staging forces the pending async save to
        # complete synchronously (flush) rather than grow.  The join
        # happens outside the lock: the save thread takes _lock itself
        # to clear staging, so waiting while holding it would deadlock
        # the moment the save path and set_capacity race.
        report = EvictionReport(self.name, capacity, capacity)
        if over:
            self.wait()
            with self._lock:
                report.evicted_bytes = self._staged_bytes
                self._staged_bytes = 0.0
        return report

    # -- save/restore ---------------------------------------------------------
    def save(self, tree, step: int) -> None:
        if not self.async_save:
            save_pytree(tree, self.directory, step)
            self._gc()
            return
        self.wait()
        # the host staging copy, taken now: the tree may change after
        host_tree = _unflatten(tree, {n: _staged(x)
                                      for n, x in flatten(tree)})
        with self._lock:
            self._staged_bytes = float(sum(
                x.nbytes for _, x in flatten(host_tree)
                if isinstance(x, np.ndarray)))

        def run():
            save_pytree(host_tree, self.directory, step)
            with self._lock:
                self._staged_bytes = 0.0
            self._gc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like, *, device: DeviceLike = None):
        """(tree, step) of the newest complete checkpoint, its tensors on
        ``device`` (the card by default), or (None, None)."""
        device = resolve_device(device)
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_pytree(tree_like, self.directory, step,
                              device=device), step

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(n) for n in os.listdir(self.directory)) if m)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:09d}"),
                          ignore_errors=True)
