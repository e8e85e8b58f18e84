"""Wrapper of the decode-attention kernel (csrc/flash_decode.cu), the port
of the Pallas kernel B6 in repro/kernels/flash_decode.py.

`flash_decode(q, k, v, length)` returns the unnormalized flash partials
(o, m, l) of one query token per row over the valid prefix of a KV cache.
k and v take the JAX package's (B, Hkv, S, d) layout as any strided view
with a unit stride on d, so the serving cache (B, W, Hkv, d) is passed as
`cache.transpose(1, 2)` and read in place. The kernel splits each row's S
cache positions into ranges of KEY_CHUNK keys, one block each; the last
block of a row merges its partials, counted on a zeroed int32 buffer kept
per device and stream that each call leaves at zero. The split count comes
from S, never from `length`, which stays on the card. It reads K and V as
16-byte vectors, so d must be a multiple of 8 (bf16) or 4 (f32) and k and v
16-byte aligned with strides that are multiples of that vector. CUDA
tensors only (kernels/ops.py routes CPU tensors to kernels/ref.py);
launches are counted in `flash_decode.launches`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor

MAX_GROUP = 16        # query heads per kv head (csrc kMaxG)
MAX_HEAD_DIM = 256    # csrc kMaxD
KEY_CHUNK = 64        # keys a block (csrc kMaxChunk = 128 at most)
# per (device, stream): the kernel's done-counters, B * Hkv int32 zeros
# that each call leaves at zero
_COUNTERS = {}


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
    vec = 16 // q.element_size()
    for name, x in (("k", k), ("v", v)):
        if not x.is_cuda or x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} must be {q.dtype} on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != (B, Hkv, S, d) or x.stride(3) != 1:
            raise ValueError(f"flash_decode: {name} must be (B, Hkv, S, d) "
                             f"= {(B, Hkv, S, d)} with unit stride on d, "
                             f"got {tuple(x.shape)} strides {x.stride()}")
        if x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3]):
            raise ValueError(f"flash_decode: {name} is read in 16-byte "
                             f"vectors: needs a 16-byte aligned base and "
                             f"strides that are multiples of {vec}, got "
                             f"strides {x.stride()}")
    check("length", length, torch.int32, (B,), dev)
    if (Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP or d > MAX_HEAD_DIM
            or d % vec):
        raise ValueError(f"flash_decode: needs H % Hkv == 0, H / Hkv <= "
                         f"{MAX_GROUP}, d <= {MAX_HEAD_DIM} and d a "
                         f"multiple of {vec}; got H={H} Hkv={Hkv} d={d}")
    n_split = max(1, -(-S // KEY_CHUNK))
    o = torch.empty((B, H, d), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    # workspace: o (B, H, n_split, d), then m and l (B, H, n_split), f32
    n_part = B * H * n_split
    ws = torch.empty(n_part * (d + 2), dtype=torch.float32, device=dev)
    o_ws = ws.data_ptr()
    m_ws, l_ws = o_ws + 4 * n_part * d, o_ws + 4 * n_part * (d + 1)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < B * Hkv:
        cnt = _COUNTERS[key] = torch.zeros(B * Hkv, dtype=torch.int32,
                                           device=dev)
    fn = function("flash_decode", "repro_flash_decode",
                  (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64,
                   I64, I32, I32, I32, I64, I64, I64, I64, I64, I64, I32,
                   I32, I32, PTR, PTR))
    ks, vs = k.stride(), v.stride()
    launch(fn, "flash_decode", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length.data_ptr(), o.data_ptr(), m.data_ptr(),
           l.data_ptr(), o_ws, m_ws, l_ws,
           B, S, H, Hkv, d, ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
           KEY_CHUNK, n_split, int(q.dtype == torch.bfloat16),
           cnt.data_ptr())
    flash_decode.launches += 1
    return o, m, l


flash_decode.launches = 0
