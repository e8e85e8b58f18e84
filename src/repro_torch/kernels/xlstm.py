"""Wrappers of the xLSTM kernels: csrc/mlstm.cu (B12 mlstm_chunkwise, B13
mlstm_step, and their backwards B15 mlstm_chunkwise_bwd and B16
mlstm_step_bwd) and csrc/slstm.cu (B14 slstm_scan and its backward B17
slstm_scan_bwd).

None of them replaces a Pallas kernel: the JAX package computes the three
cells in jnp (repro/models/lm.py `_mlstm_chunkwise`, the `step` of
`mlstm_block` and of `slstm_block`) and differentiates them with autodiff.
Each computes its plain version in kernels/ref.py (the same name) in f32,
summing in another order, and is held to it within ref.xlstm_tol (the
forwards) or ref.xlstm_bwd_tol (the backwards). CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py); launches are counted
one a call in `<name>.launches` (mlstm_chunkwise is 2 + 2 x segments
launches a call, mlstm_chunkwise_bwd 4 + 3 x segments + (segments - 1),
slstm_scan and slstm_scan_bwd one).
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
                    state_bytes: int = STATE_BYTES, with_qn: bool = False
                    ) -> Tuple[Tensor, ...]:
    """q, k, v (B, S, H, hd), i, f (B, S, H), C0 (B, H, hd, hd), n0 (B, H,
    hd), m0 (B, H), contiguous float32, hd in CHUNKWISE_HD, chunks of
    ref.mlstm_chunk(S). Returns (h (B, S, H, hd), C, n, m), new tensors;
    with with_qn also each position's q . n (B, S, H) for the backward.
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
    qn = torch.empty_like(i) if with_qn else None
    words = function("mlstm", "repro_mlstm_chunkwise_work_floats",
                     (I64, I32, I64, I32))
    words.restype = ctypes.c_longlong
    work = torch.empty(words(B, H, S, c), dtype=torch.float32, device=dev)
    states = torch.empty(B * H * seg * hd * (hd + 1), dtype=torch.float32,
                         device=dev)
    fn = function("mlstm", "repro_mlstm_chunkwise",
                  (PTR,) * 15 + (I64, I64, I32, I32, I32, I32, PTR))
    launch(fn, "mlstm_chunkwise", dev, *(x.data_ptr() for x in (
        q, k, v, i, f, C0, n0, m0, h, C, n, m)),
        None if qn is None else qn.data_ptr(), work.data_ptr(),
        states.data_ptr(), B, S, H, hd, c, seg)
    mlstm_chunkwise.launches += 1
    return (h, C, n, m, qn) if with_qn else (h, C, n, m)


def chunk_segment(B: int, S: int, H: int, hd: int,
                  state_bytes: int = STATE_BYTES) -> int:
    """The chunks of a segment of mlstm_chunkwise's scratch: as many as
    keep C's entering states (B H hd^2 f32 a chunk) within state_bytes, at
    least one, at most all S / ref.mlstm_chunk(S)."""
    nc = S // ref.mlstm_chunk(S)
    return max(1, min(nc, state_bytes // (B * H * hd * hd * 4)))


mlstm_chunkwise.launches = 0


def mlstm_chunkwise_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor,
                        f: Tensor, C0: Tensor, n0: Tensor, m0: Tensor,
                        h: Tensor, qn: Tensor, dh: Tensor, dC: Tensor,
                        dn: Tensor, dm: Tensor,
                        state_bytes: int = STATE_BYTES
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """B12's backward with respect to q, k, v, i and f: B12's inputs, its
    outputs h and qn (with_qn), dh (B, S, H, hd) and the final state's
    gradients dC, dn, dm, contiguous float32 (shapes as B12's). Returns
    (dq, dk, dv (B, S, H, hd), di, df (B, S, H)), new tensors. Each
    segment's chunk states and their gradients are kept in scratch, the
    two at most `state_bytes` together (chunk_segment of half of it, one
    chunk at least); the states entering the segments are recomputed in
    order first. 4 + 3 x segments + (segments - 1) launches, counted as
    one call."""
    if q.dim() != 4:
        raise ValueError(f"mlstm_chunkwise_bwd: q must be (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    dev = q.device
    for name, x, shape in (("q", q, (B, S, H, hd)), ("k", k, (B, S, H, hd)),
                           ("v", v, (B, S, H, hd)), ("i", i, (B, S, H)),
                           ("f", f, (B, S, H)), ("C0", C0, (B, H, hd, hd)),
                           ("n0", n0, (B, H, hd)), ("m0", m0, (B, H)),
                           ("h", h, (B, S, H, hd)), ("qn", qn, (B, S, H)),
                           ("dh", dh, (B, S, H, hd)), ("dC", dC, (B, H, hd, hd)),
                           ("dn", dn, (B, H, hd)), ("dm", dm, (B, H))):
        check(name, x, torch.float32, shape, dev)
    if hd not in CHUNKWISE_HD or 3 * B >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"mlstm_chunkwise_bwd: hd in {CHUNKWISE_HD}, 3 B "
                         f"and H < 65536 needed, got hd={hd} B={B} H={H}")
    _aligned("mlstm_chunkwise_bwd", q, k, v, h, dh, C0, dC)
    c = ref.mlstm_chunk(S)
    seg = chunk_segment(B, S, H, hd, state_bytes // 2)
    words = function("mlstm", "repro_mlstm_chunkwise_bwd_work_floats",
                     (I64, I32, I64, I32, I32, I32))
    words.restype = ctypes.c_longlong
    work = torch.empty(words(B, H, S, hd, c, seg), dtype=torch.float32,
                       device=dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i), torch.empty_like(f)
    fn = function("mlstm", "repro_mlstm_chunkwise_bwd",
                  (PTR,) * 20 + (I64, I64, I32, I32, I32, I32, PTR))
    launch(fn, "mlstm_chunkwise_bwd", dev, *(x.data_ptr() for x in (
        q, k, v, i, f, C0, n0, m0, h, qn, dh, dC, dn, dm, dq, dk, dv, di, df,
        work)), B, S, H, hd, c, seg)
    mlstm_chunkwise_bwd.launches += 1
    return dq, dk, dv, di, df


mlstm_chunkwise_bwd.launches = 0


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


def mlstm_step_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                   C: Tensor, n: Tensor, m: Tensor, dh: Tensor, dC: Tensor,
                   dn: Tensor, dm: Tensor) -> Tuple[Tensor, ...]:
    """B13's backward from the state (C, n, m) the step entered: q, k, v,
    dh (B, H, hd), i, f (B, H), the left state's gradients dC (B, H, hd,
    hd), dn (B, H, hd), dm (B, H), contiguous float32, hd in CHUNKWISE_HD
    (its row sums shuffle within power-of-two groups). Returns (dq, dk, dv,
    di, df, dC, dn, dm), new tensors, the last three the entering state's.
    One launch."""
    if q.dim() != 3:
        raise ValueError(f"mlstm_step_bwd: q must be (B, H, hd), got "
                         f"{tuple(q.shape)}")
    B, H, hd = q.shape
    dev = q.device
    for name, x, shape in (("q", q, (B, H, hd)), ("k", k, (B, H, hd)),
                           ("v", v, (B, H, hd)), ("i", i, (B, H)),
                           ("f", f, (B, H)), ("C", C, (B, H, hd, hd)),
                           ("n", n, (B, H, hd)), ("m", m, (B, H)),
                           ("dh", dh, (B, H, hd)), ("dC", dC, (B, H, hd, hd)),
                           ("dn", dn, (B, H, hd)), ("dm", dm, (B, H))):
        check(name, x, torch.float32, shape, dev)
    if hd not in CHUNKWISE_HD or B * H >= 2 ** 31:
        raise ValueError(f"mlstm_step_bwd: hd in {CHUNKWISE_HD} needed, got "
                         f"hd={hd}")
    _aligned("mlstm_step_bwd", v, dh, C, dC)
    outs = [torch.empty_like(x) for x in (q, k, v, i, f, C, n, m)]
    fn = function("mlstm", "repro_mlstm_step_bwd",
                  (PTR,) * 20 + (I64, I32, I32, PTR))
    launch(fn, "mlstm_step_bwd", dev, *(x.data_ptr() for x in (
        q, k, v, i, f, C, n, m, dh, dC, dn, dm, *outs)), B, H, hd)
    mlstm_step_bwd.launches += 1
    return tuple(outs)


mlstm_step_bwd.launches = 0


def slstm_scan(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
               c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
               keep: bool = False) -> Tuple[Tensor, ...]:
    """z, i, f, o (B, S, R), c0, n0, h0, m0 (B, R) contiguous float32; rz
    (R, R) contiguous bfloat16 or float32; S > 1 needs R <= 2048. Returns
    (hs (B, S, R), c, n, h, m), new tensors, with keep also each step's c,
    n, m and tanh(z + h rz) (4, B, S, R) for the backward. S == 1 is one
    launch of the step kernel; S > 1 one cooperative launch of the chain,
    which exchanges h through a ring of 2 B R words allocated here (and
    zeroed by the launcher) each call."""
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
    kept = (torch.empty((4, B, S, R), dtype=torch.float32, device=dev)
            if keep else None)
    fn = function("slstm", "repro_slstm_scan",
                  (PTR,) * 5 + (I32,) + (PTR,) * 11 + (I32, I64, I32, PTR))
    launch(fn, "slstm_scan", dev, z.data_ptr(), i.data_ptr(), f.data_ptr(),
           o.data_ptr(), rz.data_ptr(), int(rz.dtype == torch.bfloat16),
           *(x.data_ptr() for x in (c0, n0, h0, m0, hs, c, n, h, m)),
           None if kept is None else kept.data_ptr(),
           None if ring is None else ring.data_ptr(), B, S, R)
    slstm_scan.launches += 1
    return (hs, c, n, h, m, kept) if keep else (hs, c, n, h, m)


slstm_scan.launches = 0


def slstm_scan_bwd(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
                   c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
                   hs: Tensor, kept: Tensor, dhs: Tensor, dc: Tensor,
                   dn: Tensor, dh: Tensor, dm: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """B14's backward: its inputs, its outputs hs and kept (keep=True),
    dhs (B, S, R) and the final state's gradients dc, dn, dh, dm (B, R),
    contiguous float32 (rz bfloat16 or float32); R <= 2048 (rz's rows in
    registers, as the forward's chain). z, h0 and hs are checked, not read
    (kept holds what the cells need). Returns (dz, di, df, do) (B, S, R),
    new tensors; dz is the pre-activation's gradient. One cooperative
    launch, with a ring of 2 B R words allocated here."""
    if z.dim() != 3:
        raise ValueError(f"slstm_scan_bwd: z must be (B, S, R), got "
                         f"{tuple(z.shape)}")
    B, S, R = z.shape
    dev = z.device
    for name, x in (("z", z), ("i", i), ("f", f), ("o", o), ("hs", hs),
                    ("dhs", dhs)):
        check(name, x, torch.float32, (B, S, R), dev)
    for name, x in (("c0", c0), ("n0", n0), ("h0", h0), ("m0", m0),
                    ("dc", dc), ("dn", dn), ("dh", dh), ("dm", dm)):
        check(name, x, torch.float32, (B, R), dev)
    check("kept", kept, torch.float32, (4, B, S, R), dev)
    if rz.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"slstm_scan_bwd: rz must be bfloat16 or float32, "
                         f"got {rz.dtype}")
    check("rz", rz, rz.dtype, (R, R), dev)
    smem = function("slstm", "repro_slstm_scan_smem_bytes", (I32, I32))
    smem.restype = ctypes.c_longlong
    need = smem(B, R)
    if B >= 2 ** 16 or need < 0 or need > 232448:
        raise ValueError(f"slstm_scan_bwd: needs R <= 2048, B < 65536 and at "
                         f"most 232,448 bytes of shared memory a block; "
                         f"B={B}, R={R} need {need}")
    ring = torch.empty(2 * B * R, dtype=torch.int64, device=dev)
    dz, di, df, do = (torch.empty_like(z) for _ in range(4))
    fn = function("slstm", "repro_slstm_scan_bwd",
                  (PTR,) * 4 + (I32,) + (PTR,) * 14 + (I32, I64, I32, PTR))
    launch(fn, "slstm_scan_bwd", dev, i.data_ptr(), f.data_ptr(),
           o.data_ptr(), rz.data_ptr(), int(rz.dtype == torch.bfloat16),
           *(x.data_ptr() for x in (c0, n0, m0, kept, dhs, dc, dn, dh, dm, dz,
                                    di, df, do, ring)), B, S, R)
    slstm_scan_bwd.launches += 1
    return dz, di, df, do


slstm_scan_bwd.launches = 0
