"""Wrappers of the owner-lane CUDA kernels (csrc/owner_lane.cu), ports of
the Pallas kernels in repro/kernels/amo_apply.py:

- `amo_apply` (B1): primitive single-word AMOs [off|opcode|a|b];
- `fused_apply` (B2): fused component descriptors
  [off|opcode|a|b|aux0|aux1|vals...] in four sub-phases.

Each takes CUDA tensors only (kernels/ops.py routes CPU tensors to the
plain versions in kernels/ref.py), returns new tensors (out of place, as
the JAX contract is), and counts its calls in `<wrapper>.launches`: one a
call, though each call launches two kernels (a copy of the shards and
zeroing of the replies across the card, then the apply, one block per
owner).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor

# the kernels sort word indices and list positions as 32-bit values
MAX_WORDS = 2 ** 31 - 1


def _check_sizes(name: str, L: int, m: int) -> None:
    if not 1 <= L <= MAX_WORDS or m > MAX_WORDS:
        raise ValueError(f"{name}: needs 1 <= L <= {MAX_WORDS} words a "
                         f"shard and m <= {MAX_WORDS} ops an owner, got "
                         f"L={L}, m={m}")


def amo_apply(local: Tensor, ops: Tensor, mask: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """local (P, L) int32; ops (P, m, 4) int32; mask (P, m) bool, all
    contiguous on one card. Returns (old (P, m), local' (P, L))."""
    P, L = local.shape
    m = ops.shape[1]
    dev = local.device
    check("local", local, torch.int32, (P, L), dev)
    check("ops", ops, torch.int32, (P, m, 4), dev)
    check("mask", mask, torch.bool, (P, m), dev)
    _check_sizes("amo_apply", L, m)
    old = torch.empty((P, m), dtype=torch.int32, device=dev)
    out = torch.empty_like(local)
    fn = function("owner_lane", "repro_amo_apply",
                  (PTR, PTR, PTR, PTR, PTR, I64, I64, I64, PTR))
    launch(fn, "amo_apply", dev, local.data_ptr(), ops.data_ptr(),
           mask.data_ptr(), old.data_ptr(), out.data_ptr(), P, L, m)
    amo_apply.launches += 1
    return old, out


amo_apply.launches = 0


def fused_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                reply_width: int) -> Tuple[Tensor, Tensor]:
    """local (P, L) int32; ops (P, m, 6 + V) int32; mask (P, m) bool.
    Returns (reply (P, m, reply_width), local' (P, L))."""
    P, L = local.shape
    m, width = ops.shape[1], ops.shape[2]
    dev = local.device
    if width < 6 or reply_width < 1:
        raise ValueError("fused_apply: need 6 + V descriptor words and a "
                         "reply width >= 1")
    check("local", local, torch.int32, (P, L), dev)
    check("ops", ops, torch.int32, (P, m, width), dev)
    check("mask", mask, torch.bool, (P, m), dev)
    _check_sizes("fused_apply", L, m)
    reply = torch.empty((P, m, reply_width), dtype=torch.int32, device=dev)
    out = torch.empty_like(local)
    fn = function("owner_lane", "repro_fused_apply",
                  (PTR, PTR, PTR, PTR, PTR, I64, I64, I64, I32, I32, PTR))
    launch(fn, "fused_apply", dev, local.data_ptr(), ops.data_ptr(),
           mask.data_ptr(), reply.data_ptr(), out.data_ptr(), P, L, m,
           width, reply_width)
    fused_apply.launches += 1
    return reply, out


fused_apply.launches = 0

