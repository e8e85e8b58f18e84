"""Parity of the port's full-sequence attention with the JAX package on
the CPU: the plain version of kernel B5 (`ref.mha`, the function the CUDA
flash_attention computes), the chunked flash forward of the prefill path
(`chunked_flash` with its causal-skip split) and the LATTN block in train
mode.

Tolerances: the plain version against the JAX oracle and the Pallas
kernel (interpret mode) with tests/test_kernels.py's (2e-6 in f32, 2e-2 in
bf16); the chunked forward and the block against JAX within
test_torch_lm.py's 1e-5 (the same f32 math summed in another order).

The Pallas kernel aligns query rows to the START of the kv sequence
(`qpos = q_lo + iota`), while its own docstring, the JAX oracle and the
model's chunk mask align them to the END; the two agree only when
S == Skv. The port follows the oracle and the model, and a test pins the
difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LATTN as J_LATTN
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import lm as jlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from torch_parity import (jax_and_port_models, same,  # noqa: F401
                          torch_one_thread)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [  # B, H, Hkv, S, Skv, d, causal, window
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 8, 48, 48, 16, True, 24),
    (2, 2, 1, 32, 32, 64, False, 0),
    (2, 4, 1, 24, 56, 16, True, 0),
    (1, 16, 1, 40, 72, 32, True, 20),
    (2, 4, 2, 17, 45, 16, False, 9),
]


def _qkv(rng, B, H, Hkv, S, Skv, d):
    return (rng.normal(size=(B, H, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,Skv,d,causal,window", CASES)
def test_mha_matches_jax_ref(B, H, Hkv, S, Skv, d, causal, window, dtype):
    """S == Skv and end-aligned S < Skv, with and without a window, GQA
    and MQA; ops dispatches a CPU tensor to the plain version, which
    keeps q's dtype."""
    rng = np.random.default_rng(S * Skv + d)
    q, k, v = _qkv(rng, B, H, Hkv, S, Skv, d)
    tdt = getattr(torch, dtype)
    got = tops.flash_attention(*(torch.as_tensor(x).to(tdt)
                                 for x in (q, k, v)),
                               causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, H, S, d)
    want = jax.jit(jref.mha, static_argnames=("causal", "window"))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
        window=window)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,Skv,d,causal,window",
                         [c for c in CASES if c[3] == c[4]])
def test_mha_matches_pallas_when_aligned(B, H, Hkv, S, Skv, d, causal,
                                         window, dtype):
    """S == Skv, where the Pallas kernel's start alignment and the end
    alignment coincide: the plain version equals the interpret-mode
    kernel (tiles of 16, as test_kernels.py)."""
    rng = np.random.default_rng(S + d)
    q, k, v = _qkv(rng, B, H, Hkv, S, Skv, d)
    got = tref.mha(*(torch.as_tensor(x).to(getattr(torch, dtype))
                     for x in (q, k, v)), causal=causal, window=window)
    pal = pallas_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                       causal=causal, window=window, block_q=16, block_k=16)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pal, np.float32), atol=tol)


@pytest.mark.parametrize("window", [0, 6])
def test_pallas_start_alignment_differs_from_ref(window):
    """B=1, H=4, Hkv=1, S=8, Skv=24, d=16, causal: the interpret-mode
    Pallas kernel places query i at position i (not i + 16) and so
    differs from the JAX oracle by more than 1; the port's plain version
    equals the oracle."""
    rng = np.random.default_rng(window)
    q, k, v = _qkv(rng, 1, 4, 1, 8, 24, 16)
    want = jref.mha(*map(jnp.asarray, (q, k, v)), causal=True, window=window)
    pal = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                       window=window, block_q=8, block_k=8)
    got = tref.mha(*map(torch.as_tensor, (q, k, v)), causal=True,
                   window=window)
    assert float(np.abs(np.asarray(pal) - np.asarray(want)).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_mha_row_without_keys_gives_zero():
    """Causal with S > Skv: the first S - Skv rows have no key. The plain
    version gives 0 there, as the flash forward (l = 0) does, where the
    JAX oracle's softmax gives NaN; the other rows equal the oracle."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 2, 2, 1, 12, 5, 16)
    got = tref.mha(*map(torch.as_tensor, (q, k, v)), causal=True).numpy()
    want = np.asarray(jref.mha(*map(jnp.asarray, (q, k, v)), causal=True))
    flash = tlm._flash_fwd(*(torch.as_tensor(x).transpose(1, 2)
                             for x in (q, k, v)), True, 0, None, 4)[0]
    assert np.isnan(want[:, :, :7]).all() and (got[:, :, :7] == 0).all()
    np.testing.assert_allclose(got[:, :, 7:], want[:, :, 7:], atol=2e-6)
    np.testing.assert_allclose(flash.transpose(1, 2).numpy(), got, atol=2e-6)


@pytest.mark.parametrize("window", [0, 700])
def test_chunked_flash_matches_jax_and_plain(window):
    """S = 2304 > 2 x 1024: JAX's causal-skip split runs 2 query chunks of
    1152, the second over end-aligned keys from the window's lower bound
    (S < Skv). The port's CPU forward equals JAX's, and equals the plain
    version of B5 over the whole sequence (the function the card runs for
    each chunk)."""
    B, S, H, Hkv, hd = 1, 2304, 2, 1, 16
    rng = np.random.default_rng(window)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(lambda q, k, v: jlm.chunked_flash(
        q, k, v, causal=True, window=window))(*map(jnp.asarray, (q, k, v)))
    got = tlm.chunked_flash(*map(torch.as_tensor, (q, k, v)), causal=True,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tref.mha(*(torch.as_tensor(x).transpose(1, 2) for x in (q, k, v)),
                     causal=True, window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_lattn_block_train_matches_jax():
    """Layer 2 of reduced recurrentgemma-9b (window 32) over 40 positions,
    so early keys leave the window: the residual delta."""
    jcfg, params, tcfg, model = jax_and_port_models("recurrentgemma-9b")
    pj = jax.tree.map(lambda a: a[0], params["groups"][2][0])
    x = np.random.default_rng(10).normal(
        size=(2, 40, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jlm.attn_block_train(p, x, jcfg, J_LATTN))(
        pj, jnp.asarray(x))
    got = tlm.attn_block_train(model.layers[2].blocks[0], torch.as_tensor(x),
                               tcfg, tlm.LATTN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
