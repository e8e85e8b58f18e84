"""The port's sigmoid and silu against JAX's on the CPU (models/lm.py
`_sigmoid`, `_silu`): the RG-LRU gates, the SwiGLU FFNs (MLP blocks,
shared and dense experts) and the routed experts' FFN (`_expert_ffn`).

XLA expands jax.nn.sigmoid to 1 / (1 + exp(-x)) and jax.nn.silu to x *
sigmoid(x), each op rounded in x's type; torch.sigmoid and F.silu round
once. In bfloat16 the port must give JAX's bits. The gradient is JAX's
rule for lax.logistic, g * (s * (1 - s)), which stays finite where
exp(-x) overflows. The bf16 block cases carry JAX's `init_block` weights
across, hold the activations bit for bit wherever both sides' inputs
(the bf16 projections) are equal, and the block's output within one
output step (2**-7 of the value plus 2**-8 of its RMS, as
tests/test_torch_xlstm.py's bf16 blocks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MLP as J_MLP, MOE as J_MOE, RGLRU as J_RGLRU
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from torch_parity import torch_one_thread  # noqa: F401

J_SIGMOID = jax.jit(jax.nn.sigmoid)
J_SILU = jax.jit(jax.nn.silu)


def _f32(x) -> np.ndarray:
    """A JAX array or a torch tensor of any float type as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_values(n: int = 4096, seed: int = 0):
    """n unit-normal values rounded to bf16, as (numpy f32, JAX, torch)."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    assert np.array_equal(_f32(xj), _f32(xt))
    return x, xj, xt


@pytest.mark.parametrize("name", ["sigmoid", "silu"])
def test_bf16_activation_is_jax_bit_for_bit(name):
    """4,096 seeded bf16 values: the port's activation gives jitted JAX's
    bits on every one; torch's own rounds elsewhere on many of them."""
    _, xj, xt = _bf16_values()
    port, jax_fn, torch_fn = {
        "sigmoid": (tlm._sigmoid, J_SIGMOID, torch.sigmoid),
        "silu": (tlm._silu, J_SILU, torch.nn.functional.silu)}[name]
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16
    want = _f32(jax_fn(xj))
    np.testing.assert_array_equal(_f32(got), want)
    assert (_f32(torch_fn(xt)) != want).mean() > 0.2


@pytest.mark.parametrize("name", ["sigmoid", "silu"])
def test_f32_gradient_is_jax_and_finite(name):
    """d/dx in f32 at -100, -90, 0 and 50 (exp(-x) overflows at the first
    two): finite and equal to jax.grad's; on seeded values within 1e-6
    (the two libraries' exp differ in the last bit). Without grad the
    port's sigmoid is no autograd node."""
    port, jax_fn = {"sigmoid": (tlm._sigmoid, jax.nn.sigmoid),
                    "silu": (tlm._silu, jax.nn.silu)}[name]
    jgrad = jax.jit(jax.vmap(jax.grad(jax_fn)))
    edge = np.array([-100.0, -90.0, 0.0, 50.0], np.float32)
    rand = np.random.default_rng(1).normal(size=256).astype(np.float32) * 6
    for x, exact in ((edge, True), (rand, False)):
        xt = torch.tensor(x, requires_grad=True)
        port(xt).sum().backward()
        got, want = xt.grad.numpy(), np.asarray(jgrad(jnp.asarray(x)))
        assert np.isfinite(got).all()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        assert port(torch.tensor(edge, requires_grad=True)).grad_fn is None
    assert port(torch.tensor(edge)).grad_fn is None


def _bf16_block(arch: str, kind: str, key: int):
    """(JAX cfg, JAX params, port cfg, port block) of one block of the
    reduced config in bfloat16, JAX's init_block weights carried across."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(treg.get(arch).reduced(), dtype="bfloat16")
    pj = jlm.init_block(jcfg, kind, jax.random.PRNGKey(key))
    block = tlm.make_block(tcfg, kind, {
        name: convert._param(np.asarray(w), "cpu") for name, w in pj.items()})
    return jcfg, pj, tcfg, block


def _same_where_inputs_match(act_t, act_j, pre_t, pre_j, what):
    """The activations bit for bit wherever the two sides' bf16
    pre-activations are equal, which must be most of them."""
    pre_t, pre_j = _f32(pre_t), _f32(pre_j)
    match = pre_t == pre_j
    assert match.mean() > 0.9, (what, match.mean())
    np.testing.assert_array_equal(_f32(act_t)[match], _f32(act_j)[match],
                                  err_msg=what)


def _close_bf16(got, want):
    want = _f32(want)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(_f32(got), want, rtol=2 ** -7,
                               atol=2 ** -8 * rms)


def _x(jcfg, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(
        torch.bfloat16)


def test_bf16_rglru_block_matches_jax():
    """recurrentgemma-9b's RG-LRU block in bf16 from a carried state,
    against JAX run eagerly: the gate and r activations bit for bit where
    their projections match, the delta within one output step, the f32
    state within 1e-5. Eagerly each JAX op rounds in its own type, as the
    port's do. Under jit XLA's excess precision keeps r and the gated
    input in f32 across the casts, which no order of bf16 ops repeats:
    there the delta differs by up to one more step."""
    jcfg, pj, tcfg, block = _bf16_block("recurrentgemma-9b", J_RGLRU, 5)
    xj, xt = _x(jcfg, (2, 6, jcfg.d_model), 12)
    R = jcfg.rnn_width or jcfg.d_model
    state = np.random.default_rng(13).normal(size=(2, R)).astype(np.float32)
    yj, sj = jlm.rglru_block(pj, xj, jcfg, jnp.asarray(state))
    with torch.no_grad():
        yt, st = tlm.rglru_block(block, xt, tcfg, torch.as_tensor(state))
        ht = tlm.rms_norm(xt, block.norm, tcfg.norm_eps)
        act_t = [tlm._sigmoid(ht @ block.wg), tlm._sigmoid(ht @ block.wr)]
        pre_t = [ht @ block.wg, ht @ block.wr]
    hj = jlm.rms_norm(xj, pj["norm"], jcfg.norm_eps)
    pre_j = [hj @ pj["wg"], hj @ pj["wr"]]
    for what, a_t, p_t, p_j in zip(("gate", "r"), act_t, pre_t, pre_j):
        _same_where_inputs_match(a_t, J_SIGMOID(p_j), p_t, p_j, what)
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close_bf16(yt, yj)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=1e-5)


def test_bf16_mlp_block_matches_jax():
    """smollm-135m's SwiGLU MLP block in bf16: silu(h @ w1) bit for bit
    where the projection matches, the delta within one output step."""
    jcfg, pj, tcfg, block = _bf16_block("smollm-135m", J_MLP, 6)
    xj, xt = _x(jcfg, (2, 5, jcfg.d_model), 14)
    yj = jax.jit(lambda p, x: jlm.mlp_block(p, x, jcfg))(pj, xj)
    with torch.no_grad():
        yt = tlm.mlp_block(block, xt, tcfg)
        pre_t = tlm.rms_norm(xt, block.norm, tcfg.norm_eps) @ block.w1
        act_t = tlm._silu(pre_t)
    pre_j = jlm.rms_norm(xj, pj["norm"], jcfg.norm_eps) @ pj["w1"]
    _same_where_inputs_match(act_t, J_SILU(pre_j), pre_t, pre_j, "silu")
    assert yt.dtype == torch.bfloat16
    _close_bf16(yt, yj)


def test_bf16_moe_block_matches_jax():
    """deepseek-moe-16b's MoE block in bf16: the experts' FFN
    (`_expert_ffn`) on one seeded (E, C, D) buffer with silu bit for bit
    where the projection matches and its output within one step; the
    shared experts' silu likewise; the whole block (router, dispatch,
    routed and shared experts) within one output step."""
    jcfg, pj, tcfg, block = _bf16_block("deepseek-moe-16b", J_MOE, 7)
    E, D = jcfg.n_experts, jcfg.d_model
    bj, bt = _x(jcfg, (E, 4, D), 15)
    want = jax.jit(jlm._expert_ffn)(pj["we1"], pj["we3"], pj["we2"], bj)
    with torch.no_grad():
        got = tlm._expert_ffn(block.we1, block.we3, block.we2, bt)
        pre_t = torch.bmm(bt, block.we1)
    pre_j = jnp.einsum("ecd,edf->ecf", bj, pj["we1"])
    _same_where_inputs_match(tlm._silu(pre_t), J_SILU(pre_j), pre_t, pre_j,
                             "expert silu")
    _close_bf16(got, want)
    xj, xt = _x(jcfg, (2, 6, D), 16)
    yj = jax.jit(lambda p, x: jlm.moe_block(p, x, jcfg))(pj, xj)
    with torch.no_grad():
        yt, _ = tlm.moe_block(block, xt, tcfg)
        pre_t = tlm.rms_norm(xt, block.norm, tcfg.norm_eps) @ block.ws1
    pre_j = jlm.rms_norm(xj, pj["norm"], jcfg.norm_eps) @ pj["ws1"]
    _same_where_inputs_match(tlm._silu(pre_t), J_SILU(pre_j), pre_t, pre_j,
                             "shared silu")
    assert yt.dtype == torch.bfloat16
    _close_bf16(yt, yj)
