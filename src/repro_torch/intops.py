"""int32 arithmetic with the wraparound JAX gives, and JAX's index modes.

Torch has patchy uint32 support and signed overflow in C++ is undefined,
so sums and products are taken in int64 and wrapped to 32 bits by hand.
The index helpers reproduce what `jnp` does with an index outside
``[0, L)``: a negative index counts from the end, a plain gather clamps,
a ``mode="fill"`` gather gives 0, and a scatter drops the write.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# fetch-and-op kinds (AmoKind codes) and their identities
FAA, FOR, FAND, FXOR = 3, 4, 5, 6
IDENTITY = {FAA: 0, FOR: 0, FAND: -1, FXOR: 0}


def u32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement bits of an integer tensor as int64 in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to int32 (two's complement)."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def add(a, b) -> torch.Tensor:
    return i32(torch.as_tensor(a).to(torch.int64) + b)


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) held as int64, c a constant;
    split in 16-bit halves so no partial product leaves int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def fao(kind: int, a: torch.Tensor, b) -> torch.Tensor:
    """int32 fetch-and-op combine a (op) b for one static kind."""
    if kind == FAA:
        return add(a, b)
    if kind == FOR:
        return a | b
    if kind == FAND:
        return a & b
    if kind == FXOR:
        return a ^ b
    raise ValueError(f"not a fetch-and-op kind: {kind}")


def seg_scan(vals: torch.Tensor, first: torch.Tensor, kind: int
             ) -> torch.Tensor:
    """Inclusive segmented scan of `kind` along dim 1 of (B, n) int32
    values; a segment starts where `first` is True (first[:, 0] must be).
    Hillis-Steele doubling, exact for the associative fetch-and-ops."""
    n = vals.shape[1]
    idx = torch.arange(n, device=vals.device)
    seg_start = torch.cummax(
        torch.where(first, idx, torch.zeros_like(idx)), dim=1).values
    x = vals
    d = 1
    while d < n:
        prev = torch.cat([x[:, :d], x[:, :-d]], dim=1)
        x = torch.where(idx - d >= seg_start, fao(kind, prev, x), x)
        d *= 2
    return x


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices count from the end (numpy / jnp convention)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def clip_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index as a plain `jnp` gather uses it: wrapped, then clamped."""
    return wrap_index(idx, n).clamp(0, n - 1)


def slice_start(start: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """Start index as `lax.dynamic_slice` / `dynamic_update_slice` use it:
    wrapped, then clamped so the whole slice lies inside [0, n)."""
    return wrap_index(start, n).clamp(0, n - size)


def get_clip(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather x[b, idx[b, ...]] with the plain `jnp` clamp."""
    B, n = x.shape
    flat = clip_index(idx, n).reshape(B, -1)
    return torch.gather(x, 1, flat).reshape(idx.shape)


def get_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather with `mode="fill", fill_value=0`."""
    B, n = x.shape
    j = wrap_index(idx, n)
    inb = (j >= 0) & (j < n)
    v = torch.gather(x, 1, j.clamp(0, n - 1).reshape(B, -1)).reshape(
        idx.shape)
    return torch.where(inb, v, torch.zeros_like(v))


def set_drop(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
             ) -> torch.Tensor:
    """Row-wise out-of-place scatter x[b, idx] = vals with `mode="drop"`.
    In-range indices must be distinct within a row (callers mask
    duplicates first: CUDA gives no order among repeated indices)."""
    B, n = x.shape
    j = wrap_index(idx, n)
    j = torch.where((j >= 0) & (j < n), j, n).reshape(B, -1)
    out = torch.cat([x, x.new_zeros((B, 1))], dim=1)
    out.scatter_(1, j, vals.reshape(B, -1).to(x.dtype))
    return out[:, :n].contiguous()
