"""Wrappers of the RPC hash-table handler kernels (csrc/hash_probe.cu),
ports of the Pallas kernels in repro/kernels/hash_probe.py:

- `hash_find` (B3): independent open-addressing lookups (one launch: a
  warp's 512 slots scanned 16 a lane, its live requests walked one a
  lane);
- `hash_insert` (B4): serialized insert-or-assign per owner (two launches
  a call, a copy across the card and one block per owner; counted once).

Table layout: (P, L) int32, nslots records of rec_w = 2 + vw words
[flag | key | val...] per rank; flag low byte 0 = EMPTY, 2 = READY.
CUDA tensors only (kernels/ops.py routes CPU tensors to kernels/ref.py);
each wrapper counts its calls in `<wrapper>.launches`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor


def hash_find(table: Tensor, starts: Tensor, keys: Tensor, mask: Tensor, *,
              nslots: int, rec_w: int, max_probes: int = 8
              ) -> Tuple[Tensor, Tensor]:
    """table (P, L); starts/keys (P, m) int32, mask (P, m) bool.
    Returns (found (P, m) bool, vals (P, m, rec_w - 2) int32)."""
    P, L = table.shape
    m = starts.shape[1]
    dev = table.device
    check("table", table, torch.int32, (P, L), dev)
    for name, x in (("starts", starts), ("keys", keys)):
        check(name, x, torch.int32, (P, m), dev)
    check("mask", mask, torch.bool, (P, m), dev)
    found = torch.empty((P, m), dtype=torch.bool, device=dev)
    vals = torch.empty((P, m, rec_w - 2), dtype=torch.int32, device=dev)
    fn = function("hash_probe", "repro_hash_find",
                  (PTR, PTR, PTR, PTR, PTR, PTR, I64, I64, I64, I64, I32,
                   I32, PTR))
    launch(fn, "hash_find", dev, table.data_ptr(), starts.data_ptr(),
           keys.data_ptr(), mask.data_ptr(), found.data_ptr(),
           vals.data_ptr(), P, L, m, nslots, rec_w, max_probes)
    hash_find.launches += 1
    return found, vals


hash_find.launches = 0


def hash_insert(table: Tensor, starts: Tensor, keys: Tensor, vals: Tensor,
                mask: Tensor, *, nslots: int, rec_w: int, max_probes: int = 8
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """vals (P, m, rec_w - 2). Returns (ok (P, m) bool, probes (P, m)
    int32, table' (P, L))."""
    P, L = table.shape
    m = starts.shape[1]
    dev = table.device
    check("table", table, torch.int32, (P, L), dev)
    for name, x in (("starts", starts), ("keys", keys)):
        check(name, x, torch.int32, (P, m), dev)
    check("vals", vals, torch.int32, (P, m, rec_w - 2), dev)
    check("mask", mask, torch.bool, (P, m), dev)
    # the kernel sorts 32-bit window starts and ranks rows in int32
    if not (1 <= nslots < 2 ** 31 and 2 <= rec_w <= L and m < 2 ** 31):
        raise ValueError(f"hash_insert: needs 1 <= nslots < 2**31, 2 <= "
                         f"rec_w <= L and m < 2**31, got nslots={nslots} "
                         f"rec_w={rec_w} L={L} m={m}")
    ok = torch.empty((P, m), dtype=torch.bool, device=dev)
    probes = torch.empty((P, m), dtype=torch.int32, device=dev)
    out = torch.empty_like(table)
    fn = function("hash_probe", "repro_hash_insert",
                  (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64, I64, I64,
                   I64, I32, I32, PTR))
    launch(fn, "hash_insert", dev, table.data_ptr(), starts.data_ptr(),
           keys.data_ptr(), vals.data_ptr(), mask.data_ptr(), ok.data_ptr(),
           probes.data_ptr(), out.data_ptr(), P, L, m, nslots, rec_w,
           max_probes)
    hash_insert.launches += 1
    return ok, probes, out


hash_insert.launches = 0
