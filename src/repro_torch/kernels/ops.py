"""Device dispatch for the owner-lane and handler kernels.

A CUDA tensor launches the hand-written kernel (inputs are made
contiguous first); a CPU tensor takes the plain PyTorch version in
kernels/ref.py. There is no fallback: a kernel that fails to build or to
launch raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import amo_apply as _amo
from . import hash_probe as _hp
from . import ref

Tensor = torch.Tensor


def amo_apply(local: Tensor, ops: Tensor, mask: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Serialized AMO batch per owner. local (P, L); ops (P, m, 4) rows
    [off|opcode|a|b]; mask (P, m). Returns (old (P, m), local')."""
    if local.is_cuda:
        return _amo.amo_apply(local.contiguous(), ops.contiguous(),
                              mask.contiguous())
    return ref.amo_apply(local, ops, mask)


def fused_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                reply_width: int) -> Tuple[Tensor, Tensor]:
    """Fused descriptor batch per owner. ops (P, m, 6 + V). Returns
    (reply (P, m, reply_width), local')."""
    if local.is_cuda:
        return _amo.fused_apply(local.contiguous(), ops.contiguous(),
                                mask.contiguous(), reply_width=reply_width)
    return ref.fused_apply(local, ops, mask, reply_width=reply_width)


def hash_find(table, starts, keys, mask, *, nslots, rec_w, max_probes=8):
    """Batched lookups. Returns (found (P, m) bool, vals (P, m, rec_w-2))."""
    if table.is_cuda:
        return _hp.hash_find(table.contiguous(), starts.contiguous(),
                             keys.contiguous(), mask.contiguous(),
                             nslots=nslots, rec_w=rec_w,
                             max_probes=max_probes)
    return ref.hash_find(table, starts, keys, mask, nslots=nslots,
                         rec_w=rec_w, max_probes=max_probes)


def hash_insert(table, starts, keys, vals, mask, *, nslots, rec_w,
                max_probes=8):
    """Batched insert-or-assign. Returns (ok (P, m), probes (P, m),
    table')."""
    if table.is_cuda:
        return _hp.hash_insert(table.contiguous(), starts.contiguous(),
                               keys.contiguous(), vals.contiguous(),
                               mask.contiguous(), nslots=nslots,
                               rec_w=rec_w, max_probes=max_probes)
    return ref.hash_insert(table, starts, keys, vals, mask, nslots=nslots,
                           rec_w=rec_w, max_probes=max_probes)
