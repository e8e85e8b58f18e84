"""Wrapper of the RG-LRU scan kernel (csrc/rg_lru.cu), the port of the
Pallas kernel B8 in repro/kernels/rg_lru.py.

`rg_lru_scan(a, b, h0)` walks h_t = a_t * h_{t-1} + b_t over the sequence
axis of (B, S, D) float32 tensors from h0 (None: zeros), bit for bit as
the plain version in kernels/ref.py. `rg_lru_scan_bwd(a, h, h0, dh)`, kernel
B11 (no Pallas counterpart: JAX differentiates its scan), is its backward:
(da, db, dh0), bit for bit as ref.rg_lru_scan_bwd. CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py); launches are
counted in `rg_lru_scan.launches` and `rg_lru_scan_bwd.launches`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._launch import I32, I64, PTR, check, function, launch

Tensor = torch.Tensor


def rg_lru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """a, b (B, S, D) contiguous float32; h0 (B, D) contiguous float32 or
    None. Returns h (B, S, D) float32."""
    if a.dim() != 3:
        raise ValueError(f"rg_lru_scan: a must be (B, S, D), got "
                         f"{tuple(a.shape)}")
    B, S, D = a.shape
    dev = a.device
    check("a", a, torch.float32, (B, S, D), dev)
    check("b", b, torch.float32, (B, S, D), dev)
    if h0 is not None:
        check("h0", h0, torch.float32, (B, D), dev)
    if B >= 2 ** 16 or D >= 2 ** 31:
        raise ValueError(f"rg_lru_scan: B < 65536 and D < 2**31 needed, got "
                         f"B={B} D={D}")
    h = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    fn = function("rg_lru", "repro_rg_lru_scan",
                  (PTR, PTR, PTR, PTR, I64, I64, I32, PTR))
    launch(fn, "rg_lru_scan", dev, a.data_ptr(), b.data_ptr(),
           None if h0 is None else h0.data_ptr(), h.data_ptr(), B, S, D)
    rg_lru_scan.launches += 1
    return h


rg_lru_scan.launches = 0


def rg_lru_scan_bwd(a: Tensor, h: Tensor, h0: Optional[Tensor], dh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """a, h (the forward's output), dh (B, S, D) contiguous float32; h0
    (B, D) contiguous float32 or None. Returns (da, db (B, S, D), dh0
    (B, D)) float32."""
    if a.dim() != 3:
        raise ValueError(f"rg_lru_scan_bwd: a must be (B, S, D), got "
                         f"{tuple(a.shape)}")
    B, S, D = a.shape
    dev = a.device
    for name, x in (("a", a), ("h", h), ("dh", dh)):
        check(name, x, torch.float32, (B, S, D), dev)
    if h0 is not None:
        check("h0", h0, torch.float32, (B, D), dev)
    if B >= 2 ** 16 or D >= 2 ** 31:
        raise ValueError(f"rg_lru_scan_bwd: B < 65536 and D < 2**31 needed, "
                         f"got B={B} D={D}")
    da = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    dh0 = torch.zeros((B, D), dtype=torch.float32, device=dev)
    fn = function("rg_lru", "repro_rg_lru_scan_bwd",
                  (PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64, I64, I32, PTR))
    launch(fn, "rg_lru_scan_bwd", dev, a.data_ptr(), h.data_ptr(),
           None if h0 is None else h0.data_ptr(), dh.data_ptr(),
           da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, S, D)
    rg_lru_scan_bwd.launches += 1
    return da, db, dh0


rg_lru_scan_bwd.launches = 0
