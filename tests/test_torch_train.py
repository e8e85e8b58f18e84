"""Parity of the port's train path with the JAX package on the CPU:
FlashTrain (the autograd Function around flash attention) against JAX's
flash_train custom_vjp through chunked_flash, RgLruScan against autodiff
of the JAX oracle's scan, loss_fn and every gradient of reduced models,
and whole train steps (make_train_step: microbatch accumulation, clipping,
the optimizer).

Weights are JAX's `init_params` carried across with `convert.lm_from_numpy`
and gradients come back with `convert.lm_to_numpy`; inputs are made with
numpy from a seed. Everything is f32. The JAX side is jitted: one
compile per function and shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from torch_parity import jax_and_port_models, torch_one_thread  # noqa: F401

ARCHS = ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-9b"]


def close_tree(got, want, rtol, what):
    """Every leaf of two trees of the same structure within rtol of the
    leaf's largest magnitude (plus rtol relative)."""
    g_leaves, w_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=rtol * scale,
                                   err_msg=f"{what}: leaf {i}")


# ---------------------------------------------------------------------------
# Attention and the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,Hkv,S,Skv,window", [
    (2, 2, 40, 40, 0),       # the causal-skip split: 5 query chunks of 8
    (4, 2, 40, 40, 12),      # GQA, a window: chunks start at its bound
    (6, 2, 40, 40, 0),       # g = 3
    (4, 1, 24, 40, 0),       # end-aligned S < Skv: one flash call
    (4, 2, 24, 40, 7)])
def test_chunked_flash_grads_match_jax(H, Hkv, S, Skv, window):
    """chunked_flash with block_k = 8 in both packages: values and the
    gradients of sum(out * w) with respect to q, k and v, JAX's custom vjp
    against FlashTrain (whose backward on the CPU is ref.flash_bwd), the
    k / v slice gradients summed over the chunks by each framework's
    autodiff. Within 1e-5 relative and 1e-5 of the largest gradient (the
    same f32 math summed in another order; measured about 1e-6)."""
    B, hd = 2, 16
    rng = np.random.default_rng(H * 100 + S + window)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    w = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def jloss(q, k, v):
        out = jlm.chunked_flash(q, k, v, causal=True, window=window,
                                block_k=8)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tlm.chunked_flash(qt, kt, vt, causal=True, window=window,
                            block_k=8)
    (out * torch.as_tensor(w)).sum().backward()
    close_tree(out.detach().numpy(), jout, 1e-5, "out")
    close_tree([qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()],
               list(jgrads), 1e-5, "dq, dk, dv")


def test_flash_bwd_row_without_keys_gives_zero():
    """Causal S > Skv: the first rows see no key. Their lse is +inf, their
    output and their dq are 0, and they add nothing to dk or dv (JAX's
    backward gives zero there too)."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(size=(1, 2, 9, 16)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.normal(size=(1, 1, 4, 16)),
                            dtype=torch.float32) for _ in range(2))
    o, lse = tref.flash_fwd_lse(q, k, v, causal=True)
    assert torch.isinf(lse[..., :5]).all()
    assert torch.isfinite(lse[..., 5:]).all()
    do = torch.ones_like(o)
    dq, dk, dv = tref.flash_bwd(q, k, v, o, lse, do, causal=True)
    assert (o[..., :5, :] == 0).all() and (dq[..., :5, :] == 0).all()
    _, dk2, dv2 = tref.flash_bwd(q[..., 5:, :], k, v, o[..., 5:, :],
                                 lse[..., 5:], do[..., 5:, :], causal=True)
    torch.testing.assert_close(dk, dk2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, dv2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("given_h0", [True, False])
def test_rg_lru_scan_grads_match_jax(given_h0):
    """RgLruScan's gradients of sum(h * w) with respect to a, b and h0
    against jax.grad through the JAX oracle's scan, within 1e-5 (XLA may
    contract the multiply-adds; the port rounds each op); and the plain
    backward equals torch's autograd of the plain forward bit for bit."""
    B, S, D = 2, 37, 24
    rng = np.random.default_rng(11 + given_h0)
    a = rng.uniform(0.5, 1.0, (B, S, D)).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    w = rng.normal(size=(B, S, D)).astype(np.float32)

    def jloss(a, b, h0):
        return jnp.sum(jref.rg_lru_scan(a, b, h0 if given_h0 else None) * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(a, b, h0)
    at, bt, ht = (torch.tensor(x, requires_grad=True) for x in (a, b, h0))
    hs = tlm.RgLruScan.apply(at, bt, ht if given_h0 else None)
    (hs * torch.as_tensor(w)).sum().backward()
    got = [at.grad.numpy(), bt.grad.numpy()]
    want = [jgrads[0], jgrads[1]]
    if given_h0:
        got.append(ht.grad.numpy())
        want.append(jgrads[2])
    else:
        assert ht.grad is None
    close_tree(got, want, 1e-5, "da, db, dh0")
    a2, b2, h2 = (torch.tensor(x, requires_grad=True) for x in (a, b, h0))
    (tref.rg_lru_scan(a2, b2, h2 if given_h0 else None)
     * torch.as_tensor(w)).sum().backward()
    assert torch.equal(at.grad, a2.grad) and torch.equal(bt.grad, b2.grad)
    if given_h0:
        assert torch.equal(ht.grad, h2.grad)


# ---------------------------------------------------------------------------
# loss_fn and the gradients of whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    """jax.value_and_grad(lm.loss_fn) against the port's loss_fn and
    backward on 2 x 40 tokens with labels: the loss within 1e-5 and every
    gradient leaf within 1e-4 relative and 1e-4 of its largest magnitude
    (measured 5e-6 on the 38 layers of reduced recurrentgemma-9b). The MoE
    gradient flows through the integer tickets' gathers and scatters; the
    RG-LRU's through B11's plain version; attention's through B10's."""
    jcfg, params, tcfg, model = jax_and_port_models(name)
    tlm.set_trainable(model)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss = tlm.loss_fn(model, tcfg, {"tokens": torch.as_tensor(toks),
                                     "labels": torch.as_tensor(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    close_tree(convert.lm_to_numpy(model, "grad"), want, 1e-4, name)


def test_remat_changes_no_value():
    """cfg.remat runs each layer under torch.utils.checkpoint: the loss and
    every gradient are bit for bit those without it."""
    import dataclasses
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(treg.get("recurrentgemma-9b").reduced(),
                                  remat=remat)
        model = tlm.set_trainable(tlm.init_lm(cfg, 4, "cpu"))
        toks = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (2, 24)).astype(np.int32))
        loss = tlm.loss_fn(model, cfg, {"tokens": toks})
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_lm_to_numpy_inverts_lm_from_numpy():
    jcfg, params, tcfg, model = jax_and_port_models("recurrentgemma-9b")
    back = convert.lm_to_numpy(model)
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(np.asarray, params)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["smollm-135m", "deepseek-coder-33b",
                                  "deepseek-moe-16b"])
def test_train_steps_match_jax(name):
    """Two steps of make_train_step (accum 2 microbatches of 2 x 24
    tokens, lr 1e-3, warm-up 1 of 4 steps) in both packages, AdamW
    (smollm-135m, deepseek-moe-16b: its stacked expert leaves, the router
    and the shared experts) and Adafactor (deepseek-coder-33b): the loss
    and grad norm within 1e-5 and the weights after each step within 1e-5
    relative and 1e-5 of each leaf's largest magnitude. The first AdamW step moves
    each weight by about lr whatever its gradient's size, so the weights
    agree only where both packages' gradients agree in sign: they do."""
    jcfg, params, tcfg, model = jax_and_port_models(name)
    kw = dict(lr=1e-3, warmup=1, total_steps=4)
    jinit, jstep = jsteps.make_train_step(jcfg, **kw)
    tinit, tstep = tsteps.make_train_step(tcfg, **kw)
    jstep = jax.jit(jstep)
    jopt = jinit(params)
    topt = tinit(model)
    rng = np.random.default_rng(9)
    for step in range(2):
        toks = rng.integers(0, jcfg.vocab, (2, 2, 24)).astype(np.int32)
        params, jopt, jm = jstep(params, jopt,
                                 {"tokens": jnp.asarray(toks)},
                                 jnp.int32(step))
        model, topt, tm = tstep(model, topt, {"tokens": torch.as_tensor(toks)},
                                step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        close_tree(convert.lm_to_numpy(model), params, 1e-5,
                   f"{name} weights after step {step}")
    assert int(topt["count"]) == int(jopt["count"]) == 2
