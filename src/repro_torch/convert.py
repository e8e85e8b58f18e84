"""Carry state between the JAX package and the port.

A structure's state is its window: the (P, L) int32 words every rank owns.
The tests build a structure in JAX, carry `np.asarray(win.data)` across
with these functions, and continue the same op stream in both packages;
`to_numpy` brings the port's state back for comparison (or for a JAX
structure built from it). A model's state is its parameter tree:
`lm_from_numpy` builds the port's model from the JAX package's and
`lm_to_numpy` gives its parameters (or their gradients) back in that tree.
The cost
model's parameters are its constants: `component_costs` carries a
`ComponentCosts` across as the dict `dataclasses.asdict` gives.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.costmodel import ComponentCosts
from .core.hashtable import DHashTable
from .core.queue import DQueue
from .core.window import Window
from .models import lm


def window_from_numpy(data, device="cuda") -> Window:
    """A Window holding a copy of `data` (P, L) as int32 on `device`."""
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError(f"window data must be (P, L), got {arr.shape}")
    return Window(data=torch.tensor(arr.astype(np.int32), device=device))


def hashtable_from_numpy(data, nslots: int, val_words: int,
                         device="cuda") -> DHashTable:
    """A DHashTable over `data` (P, nslots * (2 + val_words))."""
    win = window_from_numpy(data, device)
    if win.local_size != nslots * (2 + val_words):
        raise ValueError("data width does not match nslots * rec_w")
    return DHashTable(win=win, nslots=nslots, val_words=val_words)


def queue_from_numpy(data, host: int, capacity: int, val_words: int,
                     checksum: bool = False, device="cuda") -> DQueue:
    """A DQueue over `data` (P, 4 + capacity * slot_w)."""
    win = window_from_numpy(data, device)
    slot_w = val_words + (1 if checksum else 0)
    if win.local_size != 4 + capacity * slot_w:
        raise ValueError("data width does not match 4 + capacity * slot_w")
    return DQueue(win=win, host=host, capacity=capacity,
                  val_words=val_words, checksum=checksum)


def to_numpy(x) -> np.ndarray:
    """The (P, L) int32 words of a Window, DHashTable or DQueue (or a
    tensor) as a numpy array on the host."""
    if isinstance(x, (DHashTable, DQueue)):
        x = x.win
    if isinstance(x, Window):
        x = x.data
    return x.detach().cpu().numpy()


def component_costs(d: dict) -> ComponentCosts:
    """The port's ComponentCosts with the fields of `d` (a JAX package
    ComponentCosts as `dataclasses.asdict` gives it); a key the port does
    not know raises."""
    return ComponentCosts(**d)


def _param(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same type (bfloat16 leaves, held by
    numpy as ml_dtypes' bfloat16, pass through float32 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def lm_from_numpy(cfg, params, device="cuda") -> lm.LM:
    """The port's LM holding the JAX package's `init_params` tree with
    numpy leaves: `embed`, `groups` (one tuple of block dicts per layer of
    the pattern, every leaf stacked over n_groups) and `final_norm`. The
    groups are unstacked: layer g * len(pattern) + i takes group g of
    pattern layer i."""
    groups = params["groups"]
    pattern = cfg.layer_pattern()
    layers = []
    for g in range(cfg.n_groups):
        for i, kinds in enumerate(pattern):
            blocks = [lm.make_block(cfg, kind, {
                name: _param(np.asarray(w)[g], device)
                for name, w in groups[i][b].items()})
                for b, kind in enumerate(kinds)]
            layers.append(lm.Layer(kinds, blocks))
    return lm.LM(cfg, _param(params["embed"], device), layers,
                 _param(params["final_norm"], device))


def lm_to_numpy(model: lm.LM, which: str = "param") -> dict:
    """The inverse of lm_from_numpy: JAX's `init_params` tree (`embed`,
    `final_norm`, `groups` with every leaf stacked over n_groups) holding
    the model's parameters (which="param") or their `.grad` (which="grad")
    as numpy arrays; bfloat16 leaves come back as float32 (exactly)."""
    if which not in ("param", "grad"):
        raise ValueError(f"which must be 'param' or 'grad', got {which!r}")

    def arr(p) -> np.ndarray:
        t = p if which == "param" else p.grad
        if t is None:
            raise ValueError("a parameter has no gradient")
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    cfg = model.cfg
    pattern = cfg.layer_pattern()
    n = len(pattern)
    groups = tuple(
        tuple({name: np.stack([arr(getattr(model.layers[g * n + i].blocks[b],
                                           name))
                               for g in range(cfg.n_groups)])
               for name, _ in model.layers[i].blocks[b].named_parameters(
                   recurse=False)}
              for b in range(len(kinds)))
        for i, kinds in enumerate(pattern))
    return {"embed": arr(model.embed), "groups": groups,
            "final_norm": arr(model.final_norm)}
