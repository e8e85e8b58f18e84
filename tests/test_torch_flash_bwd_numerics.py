"""The numerical design of the bf16 attention backward (kernel B10's
tensor-core path, csrc/flash_attention_bwd.cu), checked on the CPU.

`emulate_bf16_bwd` repeats the kernel's arithmetic in plain torch: q, k,
v and dO in bf16; S = q . k and dP = dO . v as f32 sums of exact bf16
products; P = exp(S scale - lse) and dS = P (dP - delta) scale in f32;
P and dS fed to the products as a bf16 part `hi` plus the bf16 part `lo`
of its rounding error; dQ, dK and dV summed in f32 and rounded once to
bf16. On every case of lane_cases.FLASH_BWD_CASES it must lie within
kernels/ref.py's flash_bwd_tol of ref.flash_bwd, the limit the kernel is
held to on the card. A second test records, without asserting, how close
a single bf16 rounding of P and dS comes to that limit: the margin the
hi / lo split buys.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import lane_cases, ref as tref
from torch_parity import torch_one_thread  # noqa: F401

LOG2E = math.log2(math.e)
_CASES = {}


def _case(i: int):
    """The bf16 inputs of FLASH_BWD_CASES[i] (q, k, v, o, lse, do as the
    kernel reads them: (B, H, S, d) views), their keywords and
    ref.flash_bwd's gradients; made once per case."""
    if i not in _CASES:
        case = lane_cases.FLASH_BWD_CASES[i]
        kw = dict(causal=case[6], window=case[7])
        q, k, v, do = (torch.as_tensor(x).to(torch.bfloat16).transpose(1, 2)
                       for x in lane_cases.flash_bwd_inputs(case))
        o, lse = tref.flash_fwd_lse(q, k, v, **kw)
        args = (q, k, v, o, lse, do)
        _CASES[i] = args, kw, tref.flash_bwd(*args, **kw)
    return _CASES[i]


def _parts(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x as the products see it: bf16 hi + bf16 lo (exact in f32), or one
    bf16 rounding."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def emulate_bf16_bwd(q, k, v, o, lse, do, *, causal, window, split=True):
    """The bf16 kernels' arithmetic in plain torch (see the module note).
    Returns (dq, dk, dv) in bf16, (B, H, S, d) / (B, Hkv, Skv, d)."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    pos = torch.arange(S)[:, None] + (Skv - S)
    key = torch.arange(Skv)[None, :]
    live = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        live &= key <= pos
    if window > 0:
        live &= key > pos - window
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.where(live, torch.exp2(s * scale_log2
                                     - lse[..., None] * LOG2E), 0.0)
    delta = (dof * of).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    pe, dse = _parts(p, split), _parts(ds, split)
    dv = torch.einsum("bhqk,bhqd->bhkd", pe, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", dse, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", dse, kf)
    dk = dk.reshape(B, Hkv, g, Skv, d).sum(2)
    dv = dv.reshape(B, Hkv, g, Skv, d).sum(2)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _worst_ratio(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) under
    ref.flash_bwd_tol over the three gradients: at most 1 within the
    limit."""
    worst = 0.0
    for g, w in zip(got, want):
        tol = tref.flash_bwd_tol(w)
        err = (g.float() - w.float()).abs()
        lim = tol["atol"] + tol["rtol"] * w.float().abs()
        worst = max(worst, float((err / lim).max()) if w.numel() else 0.0)
    return worst


@pytest.mark.parametrize("i", range(len(lane_cases.FLASH_BWD_CASES)))
def test_split_products_within_flash_bwd_tol(i):
    """The hi / lo design of P and dS against ref.flash_bwd within
    flash_bwd_tol (unchanged), every gradient."""
    args, kw, want = _case(i)
    got = emulate_bf16_bwd(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g, w, **tref.flash_bwd_tol(w))


def test_single_rounding_margin(record_property):
    """Records (no assertion on it) the worst ratio of error to limit over
    all cases with P and dS rounded once to bf16, beside the split's: a
    ratio above 1 is a case the single rounding would fail."""
    single = split = 0.0
    for i in range(len(lane_cases.FLASH_BWD_CASES)):
        args, kw, want = _case(i)
        single = max(single, _worst_ratio(
            emulate_bf16_bwd(*args, **kw, split=False), want))
        split = max(split, _worst_ratio(emulate_bf16_bwd(*args, **kw), want))
    record_property("single_rounding_worst_ratio", single)
    record_property("split_worst_ratio", split)
    print(f"worst |err| / limit over {len(lane_cases.FLASH_BWD_CASES)} cases:"
          f" single bf16 rounding of P and dS {single:.4f}, hi + lo "
          f"{split:.4f}")
    assert np.isfinite(single) and split <= 1.0
