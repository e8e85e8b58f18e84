"""Wrapper of the flash-attention backward kernel
(csrc/flash_attention_bwd.cu), kernel B10: the backward of JAX's
flash_train (repro/models/lm.py _flash_train_bwd), which has no Pallas
kernel.

`flash_attention_bwd(q, k, v, o, lse, do, causal=, window=)` is
kernels/ref.py `flash_bwd`: q, o and do take the (B, H, S, d) layout and
k, v (B, Hkv, Skv, d), as any strided views with a unit stride on d (the
model passes its (B, S, H, d) activations as `x.transpose(1, 2)`); lse is
the forward's (B, H, S) float32 log-sum-exp (flash_attention with
return_lse). Returns (dq, dk, dv) in the input type, each written
contiguous in the model's (B, S, H, d) / (B, Skv, Hkv, d) layout and
returned as its (B, H, S, d) / (B, Hkv, Skv, d) view. float32 and
bfloat16; the math is f32. CUDA tensors only (kernels/ops.py routes CPU
tensors to kernels/ref.py); one call is three launches (delta, dK/dV,
dQ), counted once in `flash_attention_bwd.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._launch import I32, PTR, check, function, launch
from .flash_attention import HEAD_DIMS

Tensor = torch.Tensor


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """q, o, do (B, H, S, d); k/v (B, Hkv, Skv, d); views with stride 1 on
    d, all float32 or all bfloat16; lse (B, H, S) contiguous float32.
    Returns (dq, dk, dv)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention_bwd: q must be (B, H, S, d), got "
                         f"{tuple(q.shape)}")
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    for name, x, shape in (("q", q, (B, H, S, d)), ("k", k, (B, Hkv, Skv, d)),
                           ("v", v, (B, Hkv, Skv, d)), ("o", o, (B, H, S, d)),
                           ("do", do, (B, H, S, d))):
        if not x.is_cuda or x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be {q.dtype} "
                             f"on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or x.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be {shape} "
                             f"with unit stride on d, got {tuple(x.shape)} "
                             f"strides {x.stride()}")
    check("lse", lse, torch.float32, (B, H, S), dev)
    if (Hkv == 0 or H % Hkv or d not in HEAD_DIMS or window < 0
            or max(B, H) >= 2 ** 16 or max(S, Skv) >= 2 ** 31):
        raise ValueError(f"flash_attention_bwd: needs H % Hkv == 0, d in "
                         f"{HEAD_DIMS}, window >= 0, B and H < 65536; got "
                         f"B={B} H={H} Hkv={Hkv} d={d} window={window}")
    dq = torch.empty((B, S, H, d), dtype=q.dtype, device=dev)
    dk = torch.zeros((B, Skv, Hkv, d), dtype=q.dtype, device=dev)
    dv = torch.zeros((B, Skv, Hkv, d), dtype=q.dtype, device=dev)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*[
        x.stride(i) for x in (q, k, v, o, do) for i in (0, 2, 1)])
    fn = function("flash_attention_bwd", "repro_flash_attention_bwd",
                  (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, I32, I32,
                   I32, I32, I32, I32, PTR, I32, I32, I32, PTR))
    launch(fn, "flash_attention_bwd", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
           S, Skv, H, Hkv, d, ctypes.addressof(strides), int(causal),
           int(window), int(q.dtype == torch.bfloat16))
    flash_attention_bwd.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


flash_attention_bwd.launches = 0
