"""Wrapper of the transactional owner lane (csrc/txn_lane.cu), B9
`txn_group_apply`: per owner, groups of rows [off|code|a|b|gid|chain]
applied all-or-nothing, a failed chain guard aborting its group. It has no
TPU counterpart (the JAX package's lane is jnp only).

It takes CUDA tensors only (kernels/ops.py routes CPU tensors to the plain
version in kernels/ref.py), returns new tensors, and counts its calls in
`txn_group_apply.launches`: one a call, though each call launches two
kernels (a copy of the shards and zeroing of the replies across the card,
then one block per owner).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch
from .amo_apply import _check_sizes

Tensor = torch.Tensor

# group flags a block keeps in shared memory (one byte each), below the
# 227 KB an H100 block may opt in to
MAX_GROUPS = 200_000


def txn_group_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                    ngroups: int) -> Tuple[Tensor, Tensor]:
    """local (P, L) int32; ops (P, m, 6) int32; mask (P, m) bool, all
    contiguous on one card. Returns (reply (P, m, 2) [old, applied],
    local' (P, L))."""
    P, L = local.shape
    m = ops.shape[1]
    dev = local.device
    check("local", local, torch.int32, (P, L), dev)
    check("ops", ops, torch.int32, (P, m, 6), dev)
    check("mask", mask, torch.bool, (P, m), dev)
    _check_sizes("txn_group_apply", L, m)
    if not 1 <= ngroups <= MAX_GROUPS:
        raise ValueError(f"txn_group_apply: needs 1 <= ngroups <= "
                         f"{MAX_GROUPS}, got {ngroups}")
    reply = torch.empty((P, m, 2), dtype=torch.int32, device=dev)
    out = torch.empty_like(local)
    work = torch.empty((P, m, 2), dtype=torch.int32, device=dev)
    fn = function("txn_lane", "repro_txn_group_apply",
                  (PTR, PTR, PTR, PTR, PTR, PTR, I64, I64, I64, I32, PTR))
    launch(fn, "txn_group_apply", dev, local.data_ptr(), ops.data_ptr(),
           mask.data_ptr(), reply.data_ptr(), out.data_ptr(),
           work.data_ptr(), P, L, m, int(ngroups))
    txn_group_apply.launches += 1
    return reply, out


txn_group_apply.launches = 0
