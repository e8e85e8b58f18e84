"""Carry a structure's state between the JAX package and the port.

A structure's state is its window: the (P, L) int32 words every rank owns.
The tests build a structure in JAX, carry `np.asarray(win.data)` across
with these functions, and continue the same op stream in both packages;
`to_numpy` brings the port's state back for comparison (or for a JAX
structure built from it).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.hashtable import DHashTable
from .core.queue import DQueue
from .core.window import Window


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
