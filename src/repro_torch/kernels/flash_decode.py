"""Wrapper of the decode-attention kernel (csrc/flash_decode.cu), the port
of the Pallas kernel B6 in repro/kernels/flash_decode.py.

`flash_decode(q, k, v, length)` returns the unnormalized flash partials
(o, m, l) of one query token per row over the valid prefix of a KV cache.
k and v take the JAX package's (B, Hkv, S, d) layout as any strided view
with a unit stride on d, so the serving cache (B, W, Hkv, d) is passed as
`cache.transpose(1, 2)` and read in place. CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py); launches are
counted in `flash_decode.launches`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor

MAX_GROUP = 16        # query heads per kv head (csrc kMaxG)
MAX_HEAD_DIM = 256    # csrc kThreads * kDimsPerThread


def flash_decode(q: Tensor, k: Tensor, v: Tensor, length: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """q (B, H, d) contiguous; k/v (B, Hkv, S, d) views with stride 1 on
    d, of q's dtype (float32 or bfloat16); length (B,) int32. Returns
    (o (B, H, d), m (B, H), l (B, H)), float32."""
    B, H, d = q.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    check("q", q, q.dtype, (B, H, d), dev)
    Hkv, S = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v)):
        if not x.is_cuda or x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} must be {q.dtype} on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != (B, Hkv, S, d) or x.stride(3) != 1:
            raise ValueError(f"flash_decode: {name} must be (B, Hkv, S, d) "
                             f"= {(B, Hkv, S, d)} with unit stride on d, "
                             f"got {tuple(x.shape)} strides {x.stride()}")
    check("length", length, torch.int32, (B,), dev)
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: needs H % Hkv == 0, H / Hkv <= "
                         f"{MAX_GROUP} and d <= {MAX_HEAD_DIM}; got H={H} "
                         f"Hkv={Hkv} d={d}")
    o = torch.empty((B, H, d), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    fn = function("flash_decode", "repro_flash_decode",
                  (PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64, I64, I32, I32,
                   I32, I64, I64, I64, I64, I64, I64, I32, PTR))
    ks, vs = k.stride(), v.stride()
    launch(fn, "flash_decode", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length.data_ptr(), o.data_ptr(), m.data_ptr(),
           l.data_ptr(), B, S, H, Hkv, d, ks[0], ks[2], ks[1], vs[0], vs[2],
           vs[1], int(q.dtype == torch.bfloat16))
    flash_decode.launches += 1
    return o, m, l


flash_decode.launches = 0
