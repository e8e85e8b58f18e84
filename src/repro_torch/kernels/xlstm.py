"""Wrappers of the xLSTM kernels: csrc/mlstm.cu (B12 mlstm_chunkwise, B13
mlstm_step) and csrc/slstm.cu (B14 slstm_scan).

None of them replaces a Pallas kernel: the JAX package computes the three
cells in jnp (repro/models/lm.py `_mlstm_chunkwise`, the `step` of
`mlstm_block` and of `slstm_block`). Each computes its plain version in
kernels/ref.py (the same name) in f32, summing in another order, and is
held to it within ref.xlstm_tol. CUDA tensors only (kernels/ops.py routes
CPU tensors to kernels/ref.py); launches are counted one a call in
`<name>.launches` (mlstm_chunkwise is 2 + 2 x segments launches a call,
slstm_scan one).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import ref
from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor

# head dims the chunkwise kernel is built for (its carry passes are
# templated)
CHUNKWISE_HD = (16, 32, 64, 128, 256, 512)
# the most bytes of chunk-entry states of C mlstm_chunkwise keeps at once
STATE_BYTES = 1 << 30


def _aligned(name: str, *xs: Tensor) -> None:
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned tensors")


def mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                    C0: Tensor, n0: Tensor, m0: Tensor,
                    state_bytes: int = STATE_BYTES
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """q, k, v (B, S, H, hd), i, f (B, S, H), C0 (B, H, hd, hd), n0 (B, H,
    hd), m0 (B, H), contiguous float32, hd in CHUNKWISE_HD, chunks of
    ref.mlstm_chunk(S). Returns (h (B, S, H, hd), C, n, m), new tensors.
    The states entering the chunks are kept in scratch for segments of
    chunk_segment(...) chunks (C's states at most `state_bytes`, one chunk
    at least): 2 + 2 x segments launches, counted as one call."""
    if q.dim() != 4:
        raise ValueError(f"mlstm_chunkwise: q must be (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    dev = q.device
    for name, x, shape in (("q", q, (B, S, H, hd)), ("k", k, (B, S, H, hd)),
                           ("v", v, (B, S, H, hd)), ("i", i, (B, S, H)),
                           ("f", f, (B, S, H)), ("C0", C0, (B, H, hd, hd)),
                           ("n0", n0, (B, H, hd)), ("m0", m0, (B, H))):
        check(name, x, torch.float32, shape, dev)
    if hd not in CHUNKWISE_HD or B >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"mlstm_chunkwise: hd in {CHUNKWISE_HD}, B and H < "
                         f"65536 needed, got hd={hd} B={B} H={H}")
    _aligned("mlstm_chunkwise", q, k, v, C0)
    c = ref.mlstm_chunk(S)
    seg = chunk_segment(B, S, H, hd, state_bytes)
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    words = function("mlstm", "repro_mlstm_chunkwise_work_floats",
                     (I64, I32, I64, I32))
    words.restype = ctypes.c_longlong
    work = torch.empty(words(B, H, S, c), dtype=torch.float32, device=dev)
    states = torch.empty(B * H * seg * hd * (hd + 1), dtype=torch.float32,
                         device=dev)
    fn = function("mlstm", "repro_mlstm_chunkwise",
                  (PTR,) * 14 + (I64, I64, I32, I32, I32, I32, PTR))
    launch(fn, "mlstm_chunkwise", dev, *(x.data_ptr() for x in (
        q, k, v, i, f, C0, n0, m0, h, C, n, m, work, states)), B, S, H, hd,
        c, seg)
    mlstm_chunkwise.launches += 1
    return h, C, n, m


def chunk_segment(B: int, S: int, H: int, hd: int,
                  state_bytes: int = STATE_BYTES) -> int:
    """The chunks of a segment of mlstm_chunkwise's scratch: as many as
    keep C's entering states (B H hd^2 f32 a chunk) within state_bytes, at
    least one, at most all S / ref.mlstm_chunk(S)."""
    nc = S // ref.mlstm_chunk(S)
    return max(1, min(nc, state_bytes // (B * H * hd * hd * 4)))


mlstm_chunkwise.launches = 0


def mlstm_step(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
               C: Tensor, n: Tensor, m: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """q, k, v (B, H, hd), i, f (B, H), C (B, H, hd, hd), n (B, H, hd), m
    (B, H), contiguous float32, hd a multiple of 8. Updates C, n, m in
    place; returns (h (B, H, hd), C, n, m)."""
    if q.dim() != 3:
        raise ValueError(f"mlstm_step: q must be (B, H, hd), got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    dev = q.device
    for name, x, shape in (("q", q, (B, H, hd)), ("k", k, (B, H, hd)),
                           ("v", v, (B, H, hd)), ("i", i, (B, H)),
                           ("f", f, (B, H)), ("C", C, (B, H, hd, hd)),
                           ("n", n, (B, H, hd)), ("m", m, (B, H))):
        check(name, x, torch.float32, shape, dev)
    if hd % 8 or hd > 2048 or B * H >= 2 ** 31:
        raise ValueError(f"mlstm_step: hd a multiple of 8 up to 2048 "
                         f"needed, got hd={hd}")
    _aligned("mlstm_step", v, C)
    h = torch.empty_like(q)
    fn = function("mlstm", "repro_mlstm_step",
                  (PTR,) * 9 + (I64, I32, I32, PTR))
    launch(fn, "mlstm_step", dev, *(x.data_ptr() for x in (
        q, k, v, i, f, C, n, m, h)), B, H, hd)
    mlstm_step.launches += 1
    return h, C, n, m


mlstm_step.launches = 0


def slstm_scan(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
               c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """z, i, f, o (B, S, R), c0, n0, h0, m0 (B, R) contiguous float32; rz
    (R, R) contiguous bfloat16 or float32; S > 1 needs R <= 2048. Returns
    (hs (B, S, R), c, n, h, m), new tensors. S == 1 is one launch of the
    step kernel; S > 1 one cooperative launch of the chain, which
    exchanges h through a ring of 2 B R words allocated here (and zeroed
    by the launcher) each call."""
    if z.dim() != 3:
        raise ValueError(f"slstm_scan: z must be (B, S, R), got "
                         f"{tuple(z.shape)}")
    B, S, R = z.shape
    dev = z.device
    for name, x in (("z", z), ("i", i), ("f", f), ("o", o)):
        check(name, x, torch.float32, (B, S, R), dev)
    for name, x in (("c0", c0), ("n0", n0), ("h0", h0), ("m0", m0)):
        check(name, x, torch.float32, (B, R), dev)
    if rz.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"slstm_scan: rz must be bfloat16 or float32, got "
                         f"{rz.dtype}")
    check("rz", rz, rz.dtype, (R, R), dev)
    if B >= 2 ** 16 or R >= 2 ** 24:
        raise ValueError(f"slstm_scan: B < 65536 and R < 2**24 needed, got "
                         f"B={B} R={R}")
    ring = None
    if S > 1:
        smem = function("slstm", "repro_slstm_scan_smem_bytes", (I32, I32))
        smem.restype = ctypes.c_longlong
        need = smem(B, R)
        if need < 0 or need > 232448:
            raise ValueError(f"slstm_scan: S > 1 needs R <= 2048 and at most "
                             f"232,448 bytes of shared memory a block; B={B}, "
                             f"R={R} need {need}")
        ring = torch.empty(2 * B * R, dtype=torch.int64, device=dev)
    hs = torch.empty_like(z)
    c, n, h, m = (torch.empty_like(c0) for _ in range(4))
    fn = function("slstm", "repro_slstm_scan",
                  (PTR,) * 5 + (I32,) + (PTR,) * 10 + (I32, I64, I32, PTR))
    launch(fn, "slstm_scan", dev, z.data_ptr(), i.data_ptr(), f.data_ptr(),
           o.data_ptr(), rz.data_ptr(), int(rz.dtype == torch.bfloat16),
           *(x.data_ptr() for x in (c0, n0, h0, m0, hs, c, n, h, m)),
           None if ring is None else ring.data_ptr(), B, S, R)
    slstm_scan.launches += 1
    return hs, c, n, h, m


slstm_scan.launches = 0
