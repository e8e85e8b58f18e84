"""Wrapper of the expert-dispatch kernel (csrc/moe_dispatch.cu), the port
of the Pallas kernel B7 in repro/kernels/moe_dispatch.py.

`moe_dispatch(ids, n_experts)` gives per-expert counts and each token's
stable position within its expert: the batched fetch-and-add ticket.
CUDA tensors only (kernels/ops.py routes CPU tensors to kernels/ref.py);
calls are counted in `moe_dispatch.launches` (one a call, also where the
call is two launches: a count of each tile, then the ranks).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor


def moe_dispatch(expert_ids: Tensor, n_experts: int) -> Tuple[Tensor, Tensor]:
    """expert_ids (T,) int32 -> (counts (E,) int32, position (T,) int32)."""
    T = expert_ids.shape[0]
    dev = expert_ids.device
    check("expert_ids", expert_ids, torch.int32, (T,), dev)
    if not 0 < n_experts < 2 ** 31:
        raise ValueError(f"moe_dispatch: n_experts {n_experts} out of range")
    # the counts, then the kernel's table of tile counts, as the source
    # sizes it
    words = function("moe_dispatch", "repro_moe_dispatch_work_words",
                     (I64, I32))(T, n_experts)
    work = torch.empty((words,), dtype=torch.int32, device=dev)
    pos = torch.empty((T,), dtype=torch.int32, device=dev)
    fn = function("moe_dispatch", "repro_moe_dispatch",
                  (PTR, PTR, PTR, I64, I32, PTR))
    launch(fn, "moe_dispatch", dev, expert_ids.data_ptr(), work.data_ptr(),
           pos.data_ptr(), T, n_experts)
    counts = work[:n_experts]
    moe_dispatch.launches += 1
    return counts, pos


moe_dispatch.launches = 0
