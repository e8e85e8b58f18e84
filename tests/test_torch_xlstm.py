"""Parity of the port's xLSTM path (xlstm-1.3b: MLSTM and SLSTM blocks)
with the JAX package on the CPU: the plain versions of kernels B12
(`mlstm_chunkwise`), B13 (`mlstm_step`) and B14 (`slstm_scan`), both
blocks in both modes, the prefill step, decode, the decode state and the
weights' round trip (serving: tests/test_torch_lm.py
test_generate_matches_jax_serve).

Weights are the JAX package's `init_params` of reduced xlstm-1.3b (16
layers, d_model 64, 2 heads of 16, RNN width 64, f32), carried across
with `convert.lm_from_numpy`; inputs are made with numpy from a seed.
Cells and blocks agree within 1e-5 (the same f32 formulas summed in
another order), logits within 1e-4, as tests/test_models.py's
decode-against-forward test holds them. The bf16 block cases hold the
output to one output step (2**-7 of the value, plus 2**-8 of its RMS for
values near 0, as kernels/ref.py mha_tol) to pin where each side casts.
The blocks run under torch.no_grad() here; with grad enabled they run
as autograd Functions, whose gradients tests/test_torch_xlstm_train.py
holds to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLSTM as J_MLSTM, SLSTM as J_SLSTM
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from torch_parity import (jax_and_port_models, same,  # noqa: F401
                          torch_one_thread)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def xlstm():
    return jax_and_port_models(ARCH, seed=3)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _mlstm_inputs(rng, B, S, H, hd, carried):
    """Pre-scaled q, k, v, gate logits and a state (zeros and m = -1e30,
    or a carried one) as f32 numpy arrays."""
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(B, S, H, hd)).astype(np.float32) * hd ** -0.25
    v = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    i = rng.normal(size=(B, S, H)).astype(np.float32)
    f = (rng.normal(size=(B, S, H)) + 2.0).astype(np.float32)
    if carried:
        state = (rng.normal(size=(B, H, hd, hd)).astype(np.float32),
                 rng.normal(size=(B, H, hd)).astype(np.float32),
                 rng.normal(size=(B, H)).astype(np.float32))
    else:
        state = (np.zeros((B, H, hd, hd), np.float32),
                 np.zeros((B, H, hd), np.float32),
                 np.full((B, H), -1e30, np.float32))
    return (q, k, v, i, f), state


@pytest.mark.parametrize("S,carried", [(6, False), (200, False),
                                       (256, False), (200, True)])
def test_mlstm_chunkwise_matches_jax(S, carried):
    """Chunks of 6 (S = 6), 8 (S = 200: 128 halved while it does not
    divide S) and 128 (S = 256), from zeros and from a carried state:
    h and the final (C, n, m)."""
    assert tref.mlstm_chunk(S) == {6: 6, 200: 8, 256: 128}[S]
    rng = np.random.default_rng(S + carried)
    xs, state = _mlstm_inputs(rng, 2, S, 2, 16, carried)
    fn = jax.jit(lambda xs, st: jlm._mlstm_chunkwise(*xs, st))
    hj, (Cj, nj, mj) = fn(tuple(map(jnp.asarray, xs)),
                          tuple(map(jnp.asarray, state)))
    got = tops.mlstm_chunkwise(*map(torch.as_tensor, xs),
                               *map(torch.as_tensor, state))
    for g, w in zip(got, (hj, Cj, nj, mj)):
        _close(g.numpy(), w)


def test_chunk_segment_bounds_the_scratch():
    """kernels/xlstm.py chunk_segment, the wrapper's segments of B12's
    chunk-entry states: the 1 x 32,768 prefill of xlstm-1.3b (4 heads of
    512) is one segment of 256 chunks (1 GiB), batch 2 two of 128, a cap
    below one chunk's states still one chunk, never more than the chunks
    there are, and the card cases' caps give their segments."""
    from repro_torch.kernels import lane_cases
    from repro_torch.kernels import xlstm as kx
    assert kx.STATE_BYTES == 2 ** 30
    assert kx.chunk_segment(1, 32768, 4, 512) == 256
    assert kx.chunk_segment(2, 32768, 4, 512) == 128
    assert kx.chunk_segment(1, 32768, 4, 512, state_bytes=1) == 1
    assert kx.chunk_segment(3, 200, 2, 16) == 200 // tref.mlstm_chunk(200)
    for case in lane_cases.MLSTM_SEGMENT_CASES:
        B, S, H, hd, _, seg = case
        assert kx.chunk_segment(B, S, H, hd,
                                lane_cases.mlstm_segment_bytes(case)) == seg
        assert seg < S // tref.mlstm_chunk(S)


def test_mlstm_step_matches_chunkwise():
    """The plain step, walked over S = 8 positions, gives the chunkwise
    form's h and state (the stabilizer is the same, JAX's decode ==
    forward): in place on the state it is given."""
    rng = np.random.default_rng(7)
    xs, state = _mlstm_inputs(rng, 2, 8, 2, 16, True)
    q, k, v, i, f = map(torch.as_tensor, xs)
    want = tops.mlstm_chunkwise(q, k, v, i, f, *map(torch.as_tensor, state))
    st = tuple(torch.as_tensor(s.copy()) for s in state)
    hs = []
    for t in range(8):
        h, C, n, m = tops.mlstm_step(q[:, t], k[:, t], v[:, t], i[:, t],
                                     f[:, t], *st)
        assert all(a is b for a, b in zip((C, n, m), st))
        hs.append(h)
    for g, w in zip((torch.stack(hs, 1), *st), want):
        _close(g.numpy(), w.numpy())


def _jax_block(params, i):
    """JAX's weights of group 0 of pattern layer i (the port's layer i)."""
    return jax.tree.map(lambda a: a[0], params["groups"][i][0])


@pytest.mark.parametrize("S", [24, 7, 1])
def test_mlstm_block_matches_jax(xlstm, S):
    """An even S (chunkwise), an odd S (a step a position) and S = 1 (one
    step), each from a carried state: the residual delta and the state.
    S == 1 updates the given state in place; S > 1 leaves it alone."""
    jcfg, params, tcfg, model = xlstm
    block = model.layers[1].blocks[0]
    assert block.kind == tlm.MLSTM
    pj = _jax_block(params, 1)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    H, hd = jcfg.n_heads, jcfg.hd
    state = (rng.normal(size=(2, H, hd, hd)).astype(np.float32),
             rng.normal(size=(2, H, hd)).astype(np.float32),
             rng.normal(size=(2, H)).astype(np.float32))
    yj, sj = jax.jit(lambda p, x, s: jlm.mlstm_block(p, x, jcfg, s))(
        pj, jnp.asarray(x), tuple(map(jnp.asarray, state)))
    st = tuple(torch.as_tensor(s.copy()) for s in state)
    with torch.no_grad():
        yt, stt = block(torch.as_tensor(x), st)
    _close(yt.numpy(), yj)
    for g, w in zip(stt, sj):
        _close(g.numpy(), w)
    if S == 1:
        assert all(a is b for a, b in zip(stt, st))
    else:
        for a, b in zip(st, state):
            same(a, b)


def test_slstm_block_matches_jax(xlstm):
    """Train mode over 24 positions (zero state) and one decode step from
    a carried state: the residual delta and the state (c, n, h, m)."""
    jcfg, params, tcfg, model = xlstm
    block = model.layers[7].blocks[0]
    assert block.kind == tlm.SLSTM
    pj = _jax_block(params, 7)
    rng = np.random.default_rng(9)
    fn = jax.jit(lambda p, x, s: jlm.slstm_block(p, x, jcfg, s))
    fn0 = jax.jit(lambda p, x: jlm.slstm_block(p, x, jcfg, None))
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    yj, sj = fn0(pj, jnp.asarray(x))
    with torch.no_grad():
        yt, st = tlm.slstm_block(block, torch.as_tensor(x), tcfg)
    _close(yt.numpy(), yj)
    for g, w in zip(st, sj):
        _close(g.numpy(), w)
    R = jcfg.rnn_width
    x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    state = tuple(rng.normal(size=(2, R)).astype(np.float32)
                  for _ in range(4))
    yj, sj = fn(pj, jnp.asarray(x1), tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        yt, st = block(torch.as_tensor(x1), tuple(map(torch.as_tensor,
                                                      state)))
    _close(yt.numpy(), yj)
    for g, w in zip(st, sj):
        _close(g.numpy(), w)


def jax_cfg():
    from repro.configs import registry as jreg
    return jreg.get(ARCH).reduced()


def port_cfg():
    from repro_torch.configs import registry as treg
    return treg.get(ARCH).reduced()


@pytest.mark.parametrize("kind", [J_MLSTM, J_SLSTM])
def test_bf16_block_matches_jax(kind):
    """One block of each kind in bfloat16 (JAX's init_block of the reduced
    config with dtype bfloat16, carried across) from a carried state, over
    6 positions (the mLSTM chunkwise) and 1: the bf16 delta within one
    output step, the f32 state within 1e-5 plus one bf16 step of the
    projections' inputs it comes from (2**-7 relative)."""
    jcfg = dataclasses.replace(jax_cfg(), dtype="bfloat16")
    tcfg = dataclasses.replace(port_cfg(), dtype="bfloat16")
    pj = jlm.init_block(jcfg, kind, jax.random.PRNGKey(4))
    block = tlm.make_block(tcfg, kind, {
        name: convert._param(np.asarray(w), "cpu") for name, w in pj.items()})
    rng = np.random.default_rng(11)
    H, hd, R = jcfg.n_heads, jcfg.hd, jcfg.rnn_width
    fn = jax.jit(lambda p, x, s: (jlm.mlstm_block if kind == J_MLSTM
                                  else jlm.slstm_block)(p, x, jcfg, s))
    for S in (6, 1):
        x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        if kind == J_MLSTM:
            state = (rng.normal(size=(2, H, hd, hd)), rng.normal(
                size=(2, H, hd)), rng.normal(size=(2, H)))
        else:
            state = tuple(rng.normal(size=(2, R)) for _ in range(4))
        state = tuple(s.astype(np.float32) for s in state)
        yj, sj = fn(pj, xb, tuple(map(jnp.asarray, state)))
        with torch.no_grad():
            yt, st = block(torch.as_tensor(x).to(torch.bfloat16),
                           tuple(torch.as_tensor(s.copy()) for s in state))
        assert yt.dtype == torch.bfloat16
        want = np.asarray(yj.astype(jnp.float32))
        rms = float(np.sqrt(np.mean(want ** 2)))
        _close(yt.float().numpy(), want, rtol=2 ** -7, atol=2 ** -8 * rms)
        for g, w in zip(st, sj):
            assert g.dtype == torch.float32
            _close(g.numpy(), w, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("S", [48, 384, 47])
def test_prefill_step_matches_jax(xlstm, S):
    """make_prefill_step at S = 48 (one chunk of 48), 384 (three chunks of
    128) and 47 (odd: a step a position): the last position's logits."""
    jcfg, params, tcfg, model = xlstm
    tok = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S)).astype(
        np.int32)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)})
    got = tsteps.make_prefill_step(tcfg)(model,
                                         {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, tcfg.vocab_padded)
    _close(got.numpy(), want, **LOGITS_TOL)


def test_decode_steps_match_jax_and_the_forward(xlstm):
    """10 teacher-forced decode steps: logits against JAX's decode_step
    and against the port's own forward at each position, and the states
    against JAX's after the last step, all within 1e-4 (the states come
    out of the whole 16-layer stack, as the logits do)."""
    jcfg, params, tcfg, model = xlstm
    B, L = 3, 10
    tok = np.random.default_rng(10).integers(0, jcfg.vocab, (B, L)).astype(
        np.int32)
    full = tlm.logits_fn(model, tcfg, tlm._forward(model, tcfg,
                                                   torch.as_tensor(tok)))
    sj = jlm.init_decode_state(jcfg, B, L)
    st = tlm.init_decode_state(tcfg, B, L, device="cpu")
    step = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t))
    for t in range(L):
        lj, sj = step(params, sj, jnp.asarray(tok[:, t]))
        lt, st = tlm.decode_step(model, st, torch.as_tensor(tok[:, t]))
        _close(lt.numpy(), lj, **LOGITS_TOL)
        _close(lt.numpy(), full[:, t].numpy(), **LOGITS_TOL)
    same(st["pos"], sj["pos"])
    pattern = jcfg.layer_pattern()
    for li, caches in enumerate(st["caches"]):
        g, i = divmod(li, len(pattern))
        for c_t, c_j in zip(caches, sj["caches"][i]):
            for a, b in zip(c_t, c_j):
                _close(a.numpy(), np.asarray(b[g]), **LOGITS_TOL)


def test_decode_state_matches_jax(xlstm):
    """(C, n, m) per MLSTM layer and (c, n, h, m) per SLSTM layer, f32,
    m = -1e30: JAX's template, unstacked; one state tensor a layer."""
    jcfg, _, tcfg, _ = xlstm
    sj = jlm.init_decode_state(jcfg, 2, 8)
    st = tlm.init_decode_state(tcfg, 2, 8, device="cpu")
    pattern = jcfg.layer_pattern()
    assert len(st["caches"]) == tcfg.n_layers
    for li, caches in enumerate(st["caches"]):
        g, i = divmod(li, len(pattern))
        (c_t,), (c_j,) = caches, sj["caches"][i]
        assert len(c_t) == len(c_j) == (3 if pattern[i] == (J_MLSTM,) else 4)
        for a, b in zip(c_t, c_j):
            assert a.dtype == torch.float32
            same(a, np.asarray(b[g]))
    same(st["pos"], sj["pos"])


def test_lm_to_numpy_round_trips(xlstm):
    """lm_to_numpy gives JAX's tree back, leaf for leaf, and lm_from_numpy
    of it rebuilds the same model."""
    jcfg, params, tcfg, model = xlstm
    back = convert.lm_to_numpy(model)
    jt = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(jt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        same(a, b)
    again = convert.lm_from_numpy(tcfg, back, "cpu")
    for (na, a), (nb, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert na == nb
        same(a, b)


@pytest.mark.parametrize("S", [24, 7])
def test_grad_enabled_gives_the_no_grad_values(xlstm, S):
    """With grad enabled the blocks run as autograd Functions
    (MlstmChunkwise at S = 24, MlstmStep a position at S = 7, SlstmScan):
    the residual deltas and states are bit for bit those without grad, and
    loss_fn runs (its gradients: tests/test_torch_xlstm_train.py)."""
    _, _, tcfg, model = xlstm
    x = torch.as_tensor(np.random.default_rng(S).normal(
        size=(2, S, tcfg.d_model)).astype(np.float32))
    for layer in (0, 7):
        block = model.layers[layer].blocks[0]
        with torch.no_grad():
            want = block(x, None)
        with torch.enable_grad():
            got = block(x.clone().requires_grad_(True), None)
        same(got[0].detach(), want[0])
        for a, b in zip(got[1], want[1]):
            same(a.detach(), b)
    with torch.enable_grad():
        loss = tlm.loss_fn(model, tcfg, {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)})
    assert loss.requires_grad is False and torch.isfinite(loss)
