"""Wrapper of the flash-attention kernel (csrc/flash_attention.cu), the
port of the Pallas kernel B5 in repro/kernels/flash_attention.py.

`flash_attention(q, k, v, causal=, window=)` is the forward GQA attention
of kernels/ref.py `mha`, queries aligned to the end of the kv sequence.
q, k and v take the JAX package's (B, H, S, d) / (B, Hkv, Skv, d) layout
as any strided views with a unit stride on d, so the model's (B, S, H, d)
activations are passed as `x.transpose(1, 2)` and read in place; the
result is written contiguous in (B, S, H, d) and returned as its
(B, H, S, d) view. bfloat16 runs on the tensor cores and copies q, k and
v in 16-byte pieces, so it needs 16-byte aligned tensors whose strides are
multiples of 8; float32 runs the scalar kernel. With return_lse, each
row's log-sum-exp of its live scores comes back too, (B, H, S) float32
(+inf for a row with no live key), for the backward
(kernels/flash_attention_bwd.py). CUDA tensors only (kernels/ops.py
routes CPU tensors to kernels/ref.py); launches are counted in
`flash_attention.launches`.
"""
from __future__ import annotations

import torch

from ._launch import I32, I64, PTR, function, launch

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64, 128, 256)    # csrc instantiations


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """q (B, H, S, d); k/v (B, Hkv, Skv, d); views with stride 1 on d, all
    float32 or all bfloat16. Returns (B, H, S, d) in q's dtype (a view of
    a contiguous (B, S, H, d) tensor), and with return_lse also lse (B, H,
    S) float32."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, S, d), got "
                         f"{tuple(q.shape)}")
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, x, shape in (("q", q, (B, H, S, d)), ("k", k, (B, Hkv, Skv, d)),
                           ("v", v, (B, Hkv, Skv, d))):
        if not x.is_cuda or x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be {shape} with "
                             f"unit stride on d, got {tuple(x.shape)} "
                             f"strides {x.stride()}")
    if (Hkv == 0 or H % Hkv or d not in HEAD_DIMS or window < 0
            or max(B, H) >= 2 ** 16 or max(S, Skv) >= 2 ** 31):
        raise ValueError(f"flash_attention: needs H % Hkv == 0, d in "
                         f"{HEAD_DIMS}, window >= 0, B and H < 65536; got "
                         f"B={B} H={H} Hkv={Hkv} d={d} window={window}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
                raise ValueError(f"flash_attention: bfloat16 {name} is "
                                 f"copied in 16-byte pieces: needs a 16-byte "
                                 f"aligned base and strides that are "
                                 f"multiples of 8, got {x.stride()}")
    o = torch.empty((B, S, H, d), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    fn = function("flash_attention", "repro_flash_attention",
                  (PTR, PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32, I32,
                   I64, I64, I64, I64, I64, I64, I64, I64, I64, I32, I32,
                   I32, PTR))
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    launch(fn, "flash_attention", dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(),
           None if lse is None else lse.data_ptr(), B, S, Skv, H, Hkv, d,
           qs[0], qs[2], qs[1], ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
           int(causal), int(window), int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    if return_lse:
        return o.transpose(1, 2), lse
    return o.transpose(1, 2)


flash_attention.launches = 0
