"""Gradient compression (port of `repro.optim.compression`): int8 block
quantization with error feedback.

Gradients are quantized to int8 codes and one f32 scale per block of 128
values of the flattened tensor (about 4.06x fewer bytes than f32), summed
across ranks in int32, rescaled, and the quantization error is fed back
into the next step's gradient (EF-SGD).

On one card the ranks are a leading axis R of every leaf, as the window's
ranks are rows of a `(P, L)` tensor: where JAX runs `compressed_mean_grads`
per rank inside `shard_map`, `psum(1)` is R here, `pmax` of the scales a
max over dim 0 and `psum` of the int32 codes a sum over dim 0 in int32.
The outputs keep the leading axis, each rank's row holding what
`shard_map` hands that rank. Rounding is half to even in both packages
(`jnp.round`, `torch.round`), so the results are JAX's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

Tensor = torch.Tensor
BLOCK = 128
SCALE_FLOOR = 1e-30


def _div(x: Tensor, c: float) -> Tensor:
    """x / c, correctly rounded on every device: CUDA turns a division by
    a Python scalar into a product with its reciprocal, which rounds
    otherwise than XLA's division and the CPU's; a tensor divisor
    divides."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _blocks(flat: Tensor) -> Tensor:
    """(..., n) f32 -> (..., ceil(n / BLOCK), BLOCK), padded with zeros."""
    pad = (-flat.shape[-1]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(*flat.shape[:-1], -1, BLOCK)


def _scales(blocks: Tensor) -> Tensor:
    """max |block| / 127, clamped at SCALE_FLOOR (f32)."""
    scale = _div(blocks.abs().amax(dim=-1), 127.0)
    return torch.clamp(scale, min=SCALE_FLOOR)


def _codes(blocks: Tensor, scale: Tensor) -> Tensor:
    return torch.clamp(torch.round(blocks / scale[..., None]),
                       -127, 127).to(torch.int8)


def compress_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """x (any shape) -> (int8 codes (nblocks, BLOCK), f32 scales (nblocks,))
    per block of the flattened tensor."""
    blocks = _blocks(x.to(torch.float32).reshape(-1))
    scale = _scales(blocks)
    return _codes(blocks, scale), scale


def decompress_int8(codes: Tensor, scales: Tensor, shape, dtype) -> Tensor:
    flat = (codes.to(torch.float32) * scales[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def _mean_leaf(g: Tensor, e: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """One leaf (R, ...) of R ranks' gradients (and their f32 errors) ->
    (the mean in every rank's row, in g's dtype; the new f32 errors)."""
    R = g.shape[0]
    gf = g.to(torch.float32)
    if e is not None:
        gf = gf + e
    n = gf[0].numel()
    blocks = _blocks(gf.reshape(R, -1))                 # (R, nb, BLOCK)
    # the max scale across ranks, so that the codes add in one scale
    gscale = _scales(blocks).amax(dim=0)                # (nb,)
    codes = _codes(blocks, gscale)
    local = codes.to(torch.float32) * gscale[:, None]
    new_err = (blocks - local).reshape(R, -1)[:, :n].reshape(gf.shape)
    summed = codes.to(torch.int32).sum(dim=0, dtype=torch.int32)
    mean = _div(summed.to(torch.float32) * gscale[:, None], R)
    mean = mean.reshape(-1)[:n].reshape(gf.shape[1:]).to(g.dtype)
    return mean.expand(gf.shape).clone(), new_err


def compressed_mean_grads(grads, error=None):
    """The int8 gradient mean over the ranks of every leaf's leading axis,
    with error feedback. `grads` is any nested structure of tensors
    (R, ...); `error` the same structure of f32 errors from the last step,
    or None. Returns (mean grads, new error state), both of grads'
    structure and shapes."""
    flat_g, spec = tree_flatten(grads)
    flat_e = [None] * len(flat_g)
    if error is not None:
        flat_e, espec = tree_flatten(error)
        if espec != spec:
            raise ValueError(f"error's structure {espec} is not grads' "
                             f"{spec}")
    out = [_mean_leaf(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten([o[0] for o in out], spec),
            tree_unflatten([o[1] for o in out], spec))
