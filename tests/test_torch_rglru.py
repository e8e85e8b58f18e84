"""Parity of the port's RG-LRU path with the JAX package on the CPU: the
plain version of kernel B8 (`rg_lru_scan`), the RGLRU block in both modes,
and the local-attention (LATTN) ring decode of recurrentgemma-9b.

The plain version is held against the JAX oracle and the Pallas kernel in
interpret mode at tests/test_kernels.py's shapes and tolerance (1e-5: XLA
may contract the recurrence's multiply-add, the port rounds twice). The
blocks run on the reduced recurrentgemma-9b (f32, width 64, window 32)
with JAX's own weights carried across, within test_torch_lm.py's 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LATTN as J_LATTN
from repro.kernels import ref as jref
from repro.kernels.rg_lru import rg_lru_scan as pallas_rg_lru_scan
from repro.models import lm as jlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from torch_parity import (jax_and_port_models, same,  # noqa: F401
                          torch_one_thread)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def rgemma():
    return jax_and_port_models("recurrentgemma-9b")


@pytest.mark.parametrize("B,S,D,bs,bd", [(2, 100, 200, 32, 64),
                                         (1, 64, 128, 256, 128),
                                         (3, 33, 50, 8, 16)])
def test_rg_lru_scan_matches_jax_and_pallas(B, S, D, bs, bd):
    """From a given h0 and from zeros (h0 None); ops dispatches a CPU
    tensor to the plain version."""
    rng = np.random.default_rng(B * S + D)
    a = rng.uniform(0.7, 1.0, (B, S, D)).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    got = tops.rg_lru_scan(*map(torch.as_tensor, (a, b, h0)))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    want = jref.rg_lru_scan(*map(jnp.asarray, (a, b, h0)))
    pal = pallas_rg_lru_scan(*map(jnp.asarray, (a, b, h0)), block_s=bs,
                             block_d=bd)
    for w in (want, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)
    got0 = tref.rg_lru_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(
        got0.numpy(), np.asarray(jref.rg_lru_scan(jnp.asarray(a),
                                                  jnp.asarray(b))), atol=1e-5)


def test_rglru_block_matches_jax(rgemma):
    """Train mode over 24 positions (h0 = 0) and one decode step from a
    carried state: the residual delta and the new state."""
    jcfg, params, tcfg, model = rgemma
    pj = jax.tree.map(lambda a: a[0], params["groups"][0][0])
    block = model.layers[0].blocks[0]
    assert block.kind == tlm.RGLRU and block.a_param.dtype == torch.float32
    rng = np.random.default_rng(5)
    fn = jax.jit(lambda p, x, s: jlm.rglru_block(p, x, jcfg, s))
    fn0 = jax.jit(lambda p, x: jlm.rglru_block(p, x, jcfg, None))
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    yj, sj = fn0(pj, jnp.asarray(x))
    yt, st = tlm.rglru_block(block, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    state = rng.normal(size=(2, jcfg.rnn_width)).astype(np.float32)
    yj, sj = fn(pj, jnp.asarray(x1), jnp.asarray(state))
    yt, st = block(torch.as_tensor(x1), torch.as_tensor(state))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_lattn_ring_decode_matches_jax(rgemma):
    """Layer 2's local attention, 44 decode steps on a ring of W = 32
    slots (the window), so slots are overwritten from step 33 on: the
    residual delta, the ring written at pos % W, every step. Rows start at
    different positions, and one row's pos is at the ring's edge."""
    jcfg, params, tcfg, model = rgemma
    pj = jax.tree.map(lambda a: a[0], params["groups"][2][0])
    block = model.layers[2].blocks[0]
    assert block.kind == tlm.LATTN
    B, W = 3, jcfg.local_window
    shape = (B, W, jcfg.n_kv_heads, jcfg.hd)
    rng = np.random.default_rng(6)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    cj = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    ct = {"k": torch.as_tensor(ck.copy()), "v": torch.as_tensor(cv.copy())}
    pos = np.array([0, 7, W - 1], np.int32)
    step = jax.jit(lambda p, x, c, q: jlm.attn_block_decode(
        p, x, jcfg, J_LATTN, c, q))
    for _ in range(44):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        yj, cj = step(pj, jnp.asarray(x), cj, jnp.asarray(pos))
        yt, ct, backend = block(torch.as_tensor(x), ct, torch.as_tensor(pos))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(ct[name].numpy(),
                                       np.asarray(cj[name]), **TOL)
        pos = pos + 1
    assert backend == tlm._decode_backend(tcfg, W, B)


def test_decode_state_matches_jax(rgemma):
    """Ring of min(window, max_len) slots per LATTN layer, (B, R) float32
    zeros per RGLRU layer, None for the MLPs: JAX's template, unstacked."""
    jcfg, _, tcfg, _ = rgemma
    for max_len in (8, 48):
        sj = jlm.init_decode_state(jcfg, 2, max_len)
        st = tlm.init_decode_state(tcfg, 2, max_len, device="cpu")
        pattern = jcfg.layer_pattern()
        for li, caches in enumerate(st["caches"]):
            g, i = divmod(li, len(pattern))
            for c_t, c_j in zip(caches, sj["caches"][i]):
                if c_j is None:
                    assert c_t is None
                elif isinstance(c_j, dict):
                    for name in ("k", "v"):
                        same(c_t[name], np.asarray(c_j[name][g]))
                else:
                    assert c_t.dtype == torch.float32
                    same(c_t, np.asarray(c_j[g]))
        same(st["pos"], sj["pos"])
