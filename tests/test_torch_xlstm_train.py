"""Parity of the port's xLSTM train path with the JAX package on the CPU:
the plain backwards of kernels B15 (`mlstm_chunkwise_bwd`), B16
(`mlstm_step_bwd`) and B17 (`slstm_scan_bwd`) against `jax.vjp` of the
JAX package's cells, the blocks' gradients through the autograd Functions
`MlstmChunkwise`, `MlstmStep` and `SlstmScan`, loss_fn and every gradient
of reduced xlstm-1.3b (tests/test_torch_xlstm_grads.py), two train
steps, and remat.

Weights are JAX's `init_params` of reduced xlstm-1.3b (16 layers,
d_model 64, 2 heads of 16, RNN width 64, f32) carried across with
`convert.lm_from_numpy`; inputs are made with numpy from a seed. The cells
agree within 1e-5 relative and 1e-5 of each gradient's largest magnitude
(the same f32 formulas summed in another order), the whole model within
1e-4, as tests/test_torch_train.py holds the other families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from torch_parity import jax_and_port_models, torch_one_thread  # noqa: F401

ARCH = "xlstm-1.3b"


def close(got, want, rtol, what):
    """Arrays (or lists of them) within rtol relative and rtol of each
    one's largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=rtol * scale,
                                   err_msg=f"{what}: output {i}")


@pytest.fixture(scope="module")
def xlstm():
    return jax_and_port_models(ARCH, seed=3)


def _mlstm_inputs(rng, B, S, H, hd, q_scale):
    """Pre-scaled q (times q_scale), k, v, gate logits and a carried
    state, f32 numpy."""
    q = (rng.normal(size=(B, S, H, hd)) * hd ** -0.5 * q_scale
         ).astype(np.float32)
    k = (rng.normal(size=(B, S, H, hd)) * hd ** -0.25).astype(np.float32)
    v = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    i = rng.normal(size=(B, S, H)).astype(np.float32)
    f = (rng.normal(size=(B, S, H)) + 2.0).astype(np.float32)
    state = (rng.normal(size=(B, H, hd, hd)).astype(np.float32),
             np.abs(rng.normal(size=(B, H, hd))).astype(np.float32),
             rng.normal(size=(B, H)).astype(np.float32))
    return (q, k, v, i, f), state


@pytest.mark.parametrize("S,q_scale", [(6, 1.0), (200, 1.0), (384, 1.0),
                                       (200, 30.0)])
def test_mlstm_chunkwise_bwd_matches_jax(S, q_scale):
    """B15's plain version against jax.vjp of _mlstm_chunkwise with
    random cotangents of h and of the final (C, n, m): chunks of 6, 8
    (S = 200) and 128 (three of them), with |q . n| mostly below 1
    (q_scale 1: the normalizer is max(., 1) = 1) and mostly above it
    (q_scale 30), so that both sides of the max carry gradient."""
    rng = np.random.default_rng(S + int(q_scale))
    xs, state = _mlstm_inputs(rng, 2, S, 2, 16, q_scale)
    h, *_ = jlm._mlstm_chunkwise(*map(jnp.asarray, xs),
                                 tuple(map(jnp.asarray, state)))
    cts = (rng.normal(size=h.shape).astype(np.float32),
           rng.normal(size=state[0].shape).astype(np.float32),
           rng.normal(size=state[1].shape).astype(np.float32),
           rng.normal(size=state[2].shape).astype(np.float32))

    def fn(*xs):
        h, (C, n, m) = jlm._mlstm_chunkwise(*xs, tuple(map(jnp.asarray,
                                                           state)))
        return h, C, n, m
    _, vjp = jax.vjp(fn, *map(jnp.asarray, xs))
    want = jax.jit(vjp)(tuple(map(jnp.asarray, cts)))
    tx = [torch.as_tensor(x) for x in (*xs, *state)]
    h, C, n, m, qn = tops.mlstm_chunkwise(*tx, with_qn=True)
    den = qn.abs()
    assert (float((den > 1).float().mean()) > 0.5) == (q_scale > 1)
    got = tops.mlstm_chunkwise_bwd(*tx, h, qn,
                                   *map(torch.as_tensor, cts))
    close([g.numpy() for g in got], want, 1e-5, f"S={S} q x {q_scale}")


def test_tie_gradients_pinned():
    """Where the stabilizer or the normalizer ties, each side's rule. The
    maxima split the gradient in halves at an exact tie in both packages
    (jnp.maximum, torch.maximum): m against the running max (m equal to
    rel_0) and max(|q . n|, 1) (q . n = 1 exactly) match JAX's. An exact
    tie of rel values inside the cummax: JAX's associative scan may split
    the gradient among the tied positions in proportions of its own tree,
    the port (torch.cummax, and kernel B15) gives it all to the latest;
    only the sum over the tied positions is held, and every other
    gradient."""
    B, S, H, hd = 1, 4, 1, 2
    q = np.zeros((B, S, H, hd), np.float32)
    q[0, :, 0, 0] = 1.0
    k = np.zeros((B, S, H, hd), np.float32)
    k[0, :, 0, 1] = 0.5
    v = np.ones((B, S, H, hd), np.float32)
    # f = 200: logsigmoid(f) rounds to 0, so F = 0 and rel = i exactly;
    # rel_0 == rel_2 (a cummax tie) == m, rel_1 and rel_3 below them
    f = np.full((B, S, H), 200.0, np.float32)
    i = np.array([0.5, -1.0, 0.5, -1.0], np.float32).reshape(B, S, H)
    C0 = np.zeros((B, H, hd, hd), np.float32)
    n0 = np.zeros((B, H, hd), np.float32)
    n0[0, 0, 0] = 1.0             # q . n = exp(m - M) = 1 at t = 0
    m0 = np.full((B, H), 0.5, np.float32)
    xs, state = (q, k, v, i, f), (C0, n0, m0)
    dh = np.ones((B, S, H, hd), np.float32)
    zeros = tuple(np.zeros_like(s) for s in state)

    def fn(*xs):
        h, (C, n, m) = jlm._mlstm_chunkwise(*xs, tuple(map(jnp.asarray,
                                                           state)))
        return h, C, n, m
    _, vjp = jax.vjp(fn, *map(jnp.asarray, xs))
    want = [np.asarray(w) for w in vjp((jnp.asarray(dh),
                                        *map(jnp.asarray, zeros)))]
    tx = [torch.as_tensor(x) for x in (*xs, *state)]
    h, C, n, m, qn = tops.mlstm_chunkwise(*tx, with_qn=True)
    assert float(qn[0, 0, 0]) == 1.0
    got = [g.numpy() for g in tops.mlstm_chunkwise_bwd(
        *tx, h, qn, torch.as_tensor(dh), *map(torch.as_tensor, zeros))]
    close(got[:3] + got[4:], want[:3] + want[4:], 1e-6, "dq, dk, dv, df")
    di_j, di_t = want[3][0, :, 0], got[3][0, :, 0]
    np.testing.assert_allclose(di_t[[1, 3]], di_j[[1, 3]], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(di_t[0] + di_t[2], di_j[0] + di_j[2],
                               rtol=1e-6, atol=1e-6)


def _block_grads(block, jp, keys):
    return [block.__getattr__(k).grad.numpy() for k in keys], \
        [np.asarray(jp[k]) for k in keys]


@pytest.mark.parametrize("S", [24, 7, 1])
def test_mlstm_block_grads_match_jax(xlstm, S):
    """jax.vjp of mlstm_block against the block's backward with a random
    cotangent of the residual delta: an even S (MlstmChunkwise), an odd S
    (MlstmStep a position, each step's state carried to the next) and S =
    1, from zeros (S = 24) and from a carried state (S = 7, 1, whose
    gradient is compared too): the gradients of x and of every weight."""
    jcfg, params, tcfg, model = xlstm
    tlm.set_trainable(model)
    block = model.layers[1].blocks[0]
    assert block.kind == tlm.MLSTM
    pj = jax.tree.map(lambda a: a[0], params["groups"][1][0])
    rng = np.random.default_rng(S + 50)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    H, hd = jcfg.n_heads, jcfg.hd
    state = None if S == 24 else (
        rng.normal(size=(2, H, hd, hd)).astype(np.float32),
        rng.normal(size=(2, H, hd)).astype(np.float32),
        rng.normal(size=(2, H)).astype(np.float32))
    argn = (0, 1) if state is None else (0, 1, 2)
    jfn = jax.jit(jax.grad(lambda p, x, s: jnp.sum(
        jlm.mlstm_block(p, x, jcfg, s)[0] * w), argnums=argn))
    jg = jfn(pj, jnp.asarray(x),
             None if state is None else tuple(map(jnp.asarray, state)))
    block.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    st = None if state is None else tuple(
        torch.tensor(s, requires_grad=True) for s in state)
    y, _ = block(xt, st)
    (y * torch.as_tensor(w)).sum().backward()
    keys = sorted(pj)
    got, want = _block_grads(block, jg[0], keys)
    close(got + [xt.grad.numpy()], want + [np.asarray(jg[1])], 1e-5,
          f"mlstm block S={S}")
    if state is not None:
        close([s.grad.numpy() for s in st], [np.asarray(a) for a in jg[2]],
              1e-5, f"mlstm block S={S} state")
        for a, b in zip(st, state):       # out of place under grad
            np.testing.assert_array_equal(a.detach().numpy(), b)
    tlm.set_trainable(model, False)


def test_slstm_block_grads_match_jax(xlstm):
    """jax.vjp of slstm_block over 24 positions from zeros against the
    block's backward (SlstmScan: B17's plain version, rz's gradient one
    product on its dz): the gradients of x and of every weight."""
    jcfg, params, tcfg, model = xlstm
    tlm.set_trainable(model)
    block = model.layers[7].blocks[0]
    assert block.kind == tlm.SLSTM
    pj = jax.tree.map(lambda a: a[0], params["groups"][7][0])
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(
        jlm.slstm_block(p, x, jcfg, None)[0] * w), argnums=(0, 1)))(
        pj, jnp.asarray(x))
    block.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    y, _ = block(xt, None)
    (y * torch.as_tensor(w)).sum().backward()
    keys = sorted(pj)
    got, want = _block_grads(block, jg[0], keys)
    close(got + [xt.grad.numpy()], want + [np.asarray(jg[1])], 1e-5,
          "slstm block")
    tlm.set_trainable(model, False)


def test_state_requiring_grad_is_refused(xlstm):
    """MlstmChunkwise and SlstmScan give the entering state no gradient:
    a state that requires grad is refused with an error naming the limit
    (loss_fn starts every block from zeros); MlstmStep takes one."""
    _, _, tcfg, model = xlstm
    H, hd, R = tcfg.n_heads, tcfg.hd, tcfg.rnn_width
    x = torch.zeros(1, 2, tcfg.d_model)
    mst = tuple(torch.zeros(s, requires_grad=True)
                for s in ((1, H, hd, hd), (1, H, hd), (1, H)))
    with torch.enable_grad():
        with pytest.raises(NotImplementedError, match="entering state"):
            tlm.mlstm_block(model.layers[0].blocks[0], x, tcfg, mst)
        with pytest.raises(NotImplementedError, match="entering state"):
            tlm.slstm_block(model.layers[7].blocks[0], x, tcfg, tuple(
                torch.zeros(1, R, requires_grad=True) for _ in range(4)))
        y, _ = tlm.mlstm_block(model.layers[0].blocks[0], x[:, :1], tcfg,
                               mst)
        y.sum().backward()
    assert all(s.grad is not None for s in mst)


def test_train_steps_match_jax():
    """Two steps of make_train_step (AdamW, accum 2 microbatches of 2 x
    24 tokens, lr 1e-3, warm-up 1 of 4 steps) in both packages: the loss
    and grad norm of each step within 1e-5, the weights after the first
    within 1e-5 relative and 1e-5 of each leaf's largest magnitude. The
    gradients agree to about 1e-5 of each leaf's largest (the stabilizer's
    exponentials carry f32 rounding of exponents near 88), and the second
    AdamW step divides each element's first moment by its own RMS: where
    the two steps' gradients of an element nearly cancel, that error
    becomes a share of the step (measured up to 2.7e-4 of a norm leaf's
    magnitude, lr 1e-3); so after the second step the weights are held
    within 1e-5 relative and lr / 2 of each leaf's largest magnitude."""
    jcfg, params, tcfg, model = jax_and_port_models(ARCH, seed=5)
    kw = dict(lr=1e-3, warmup=1, total_steps=4)
    jinit, jstep = jsteps.make_train_step(jcfg, **kw)
    tinit, tstep = tsteps.make_train_step(tcfg, **kw)
    jstep = jax.jit(jstep)
    jopt, topt = jinit(params), tinit(model)
    rng = np.random.default_rng(13)
    for step in range(2):
        toks = rng.integers(0, jcfg.vocab, (2, 2, 24)).astype(np.int32)
        params, jopt, jm = jstep(params, jopt, {"tokens": jnp.asarray(toks)},
                                 jnp.int32(step))
        model, topt, tm = tstep(model, topt,
                                {"tokens": torch.as_tensor(toks)}, step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        got = jax.tree.leaves(convert.lm_to_numpy(model))
        want = jax.tree.leaves(params)
        if step == 0:
            close(got, want, 1e-5, "weights after step 0")
            continue
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=kw["lr"] / 2 * float(np.abs(w).max()),
                err_msg=f"weights after step 1: leaf {i}")


@pytest.mark.parametrize("S", [24, 7])
def test_remat_changes_no_value(S):
    """cfg.remat runs each layer under torch.utils.checkpoint: the loss and
    every gradient bit for bit those without it, the chunkwise cell (S =
    24) and the steps (S = 7) recomputed in the backward."""
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(treg.get(ARCH).reduced(), remat=remat)
        model = tlm.set_trainable(tlm.init_lm(cfg, 4, "cpu"))
        toks = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (2, S)).astype(np.int32))
        loss = tlm.loss_fn(model, cfg, {"tokens": toks})
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_plain_backwards_agree_with_each_other():
    """B16's plain version walked over an even S, from the chunkwise
    form's entering state, gives B15's plain gradients (decode == forward
    for the gradients too), and B17's dz gives rz's gradient as autograd
    through the plain scan does."""
    rng = np.random.default_rng(21)
    xs, state = _mlstm_inputs(rng, 2, 8, 2, 16, 1.0)
    tx = [torch.as_tensor(x) for x in (*xs, *state)]
    h, C, n, m, qn = tref.mlstm_chunkwise(*tx, with_qn=True)
    dh = torch.as_tensor(rng.normal(size=h.shape).astype(np.float32))
    zeros = [torch.zeros_like(t) for t in (C, n, m)]
    want = tref.mlstm_chunkwise_bwd(*tx, h, qn, dh, *zeros)
    states, st = [], tuple(tx[5:])
    for t in range(8):
        states.append(st)
        st = tref.mlstm_step_new(*(x[:, t] for x in tx[:5]), *st)[1:]
    carry = zeros
    got = [torch.zeros_like(x) for x in tx[:5]]
    for t in range(7, -1, -1):
        g = tref.mlstm_step_bwd(*(x[:, t] for x in tx[:5]), *states[t],
                                dh[:, t], *carry)
        for acc, d in zip(got, g[:5]):
            acc[:, t] = d
        carry = g[5:]
    close([g.numpy() for g in got], [w.numpy() for w in want], 1e-5,
          "steps against chunkwise")
    R = 8
    rs = np.random.default_rng(22)
    z, i, f, o = (torch.as_tensor(rs.normal(size=(2, 6, R)).astype(
        np.float32)) for _ in range(4))
    rz = torch.tensor(rs.normal(size=(R, R)).astype(np.float32) * 0.3,
                      requires_grad=True)
    st = [torch.zeros(2, R) for _ in range(3)] + [torch.full((2, R), -1e30)]
    st = [st[0], st[1], st[2], st[3]]
    hs, *_ = tref.slstm_scan(z, i, f, o, rz, *st)
    dhs = torch.as_tensor(rs.normal(size=hs.shape).astype(np.float32))
    (hs * dhs).sum().backward()
    dz, *_ = tref.slstm_scan_bwd(z, i, f, o, rz.detach(), *st, hs.detach(),
                                 None, dhs, None, None, None, None)
    hprev = torch.cat((st[2][:, None], hs.detach()[:, :-1]), 1)
    drz = hprev.reshape(-1, R).t() @ dz.reshape(-1, R)
    torch.testing.assert_close(drz, rz.grad, rtol=1e-5, atol=1e-6)
