"""Fault-tolerant checkpointing (port of `repro.runtime.checkpoint`):
atomic manifests, async write-behind, device-independent restore.

Layout, as the JAX package's:
  <dir>/step_<N>.tmp/...   (written)
  <dir>/step_<N>/          (atomic rename on completion)
    manifest.json          {step, n_leaves, treedef, leaves: shape, dtype}
    leaf_<i>.npy           one file per leaf of the tree

A tree is nested dicts (flattened in sorted key order, as jax.tree does),
lists and tuples of tensors, numpy arrays or scalars; None is no leaf.
A bfloat16 tensor, which numpy cannot hold, is saved as its int16 bits
with "bfloat16" in the manifest and comes back bit for bit.

Restart protocol: `latest_step` scans for the highest *complete* step
(the rename is the commit point: a crash mid-write leaves only a .tmp,
which is ignored and garbage-collected). `load_checkpoint` gives CPU
tensors in the template's structure; `restore_sharded` places them on a
device, which on one device is all that JAX's placement under a mesh
does.

The async writer is the write-behind queue: the train loop snapshots to
the host (the only sync point) and hands the write to a daemon thread, so
step N+1's compute overlaps step N's I/O.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue as pyqueue
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class _Snapshot:
    """A leaf copied to the host: its numpy array (a bfloat16 tensor's
    int16 bits) and the name of its type."""

    def __init__(self, x):
        if isinstance(x, _Snapshot):
            self.arr, self.dtype = x.arr, x.dtype
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu()
            self.dtype = str(t.dtype).replace("torch.", "")
            self.arr = (t.view(torch.int16) if t.dtype == torch.bfloat16
                        else t).numpy().copy()
        else:
            self.arr = np.array(x)
            self.dtype = str(self.arr.dtype)


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    """(leaves, structure) in jax.tree's order: dict keys sorted, lists
    and tuples in order, None no leaf."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, None, tuple(walk(v) for v in x))
        if x is None:
            return ("none", None, ())
        leaves.append(x)
        return ("leaf", None, ())

    return leaves, walk(tree)


def tree_unflatten(spec: tuple, leaves: List[Any]):
    """The tree of structure `spec` (from tree_flatten) holding `leaves`
    in order."""
    it = iter(leaves)

    def build(sp):
        kind, keys, kids = sp
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        return tuple(vals) if kind == "tuple" else vals

    return build(spec)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves, spec = tree_flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": repr(spec), "leaves": []}
    for i, leaf in enumerate(leaves):
        snap = _Snapshot(leaf)
        np.save(tmp / f"leaf_{i}.npy", snap.arr)
        manifest["leaves"].append({"index": i, "shape": list(snap.arr.shape),
                                   "dtype": snap.dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)          # commit point
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp") and \
                (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, template: Any) -> Any:
    """Load into the structure of `template` (leaf order must match), as
    CPU tensors of the saved types."""
    d = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves, spec = tree_flatten(template)
    assert manifest["n_leaves"] == len(leaves), \
        f"checkpoint has {manifest['n_leaves']} leaves, template " \
        f"{len(leaves)}"
    loaded = []
    for i, meta in enumerate(manifest["leaves"]):
        t = torch.from_numpy(np.load(d / f"leaf_{i}.npy"))
        loaded.append(t.view(torch.bfloat16) if meta["dtype"] == "bfloat16"
                      else t)
    return tree_unflatten(spec, loaded)


def restore_sharded(directory: str, step: int, template: Any,
                    device="cuda") -> Any:
    """Elastic restore: load the full leaves and place them on `device`
    (JAX places them under a mesh's shardings; one device holds all)."""
    leaves, spec = tree_flatten(load_checkpoint(directory, step, template))
    return tree_unflatten(spec, [t.to(device) for t in leaves])


def gc_checkpoints(directory: str, keep: int = 3):
    d = pathlib.Path(directory)
    if not d.exists():
        return
    steps = sorted([int(p.name.split("_")[1]) for p in d.iterdir()
                    if p.is_dir() and p.name.startswith("step_")
                    and not p.name.endswith(".tmp")])
    for s in steps[:-keep]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)
    for p in d.iterdir():
        if p.name.endswith(".tmp"):
            shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Write-behind checkpointing: snapshot to the host on the caller
    thread (cheap), serialize on a daemon thread. At most `depth`
    outstanding writes; `wait()` drains (call before exit / before
    restore)."""

    def __init__(self, directory: str, keep: int = 3, depth: int = 1):
        self.directory = directory
        self.keep = keep
        self._q: pyqueue.Queue = pyqueue.Queue(maxsize=depth)
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree = item
            try:
                save_checkpoint(self.directory, step, host_tree)
                gc_checkpoints(self.directory, self.keep)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any):
        leaves, spec = tree_flatten(tree)
        snapshot = tree_unflatten(spec, [_Snapshot(x) for x in leaves])
        self._q.put((step, snapshot))

    def wait(self):
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self):
        self._q.put(None)
        self._q.join()
