"""Parity of the port's xLSTM train path with the JAX package on the CPU,
the whole model: loss_fn and every gradient of reduced xlstm-1.3b (16
layers, d_model 64, 2 heads of 16, RNN width 64, f32; JAX's `init_params`
carried across with `convert.lm_from_numpy`) against
`jax.value_and_grad(lm.loss_fn)`, through the autograd Functions
`MlstmChunkwise`, `MlstmStep` and `SlstmScan` and their plain backwards
(the cells: tests/test_torch_xlstm_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.models import lm as tlm
from torch_parity import jax_and_port_models, torch_one_thread  # noqa: F401

ARCH = "xlstm-1.3b"


def close(got, want, rtol, what):
    """Lists of arrays within rtol relative and rtol of each one's largest
    magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=rtol * scale,
                                   err_msg=f"{what}: leaf {i}")


@pytest.fixture(scope="module")
def xlstm():
    return jax_and_port_models(ARCH, seed=3)


@pytest.mark.parametrize("S", [40, 256, 41])
def test_loss_and_grads_match_jax(xlstm, S, monkeypatch):
    """jax.value_and_grad(lm.loss_fn) against the port's loss_fn and
    backward on 2 x S tokens: the loss within 1e-5 and every gradient leaf
    within 1e-4 relative and 1e-4 of its largest magnitude. S = 40: one
    chunk of 40 (mLSTM) and a plain scan (sLSTM); S = 41: a step a
    position, where the gradient chains through each step's state (an
    mLSTM step that updated its entering state in place gave gradients 2x
    off); S = 256: two chunks of 128 and JAX's two-level remat scan
    (sLSTM). There JAX's chunkwise gradient is NaN in every leaf of the
    first 8 layers: autodiff of where(tri, exp(rel - M), 0) takes 0 *
    exp(.) above the diagonal, where rel_s - M_t passes 88.7 (128
    positions of a forget gate near 0.5) and exp overflows. The port
    masks before the exp (the same forward) and its gradients are finite;
    they are held to JAX's where JAX's are finite, and in full to JAX's
    sequential mLSTM cell (perf flag mlstm_chunked off: the same function,
    no select) within 5e-4 of each leaf's largest magnitude: through 16
    layers of exponents near 88.7 the f32 gradient carries noise of that
    size (measured 1.4e-4; 2.9e-4 against a copy of JAX's chunkwise cell
    masked before its exp)."""
    from repro import perf
    jcfg, params, tcfg, model = xlstm
    tlm.set_trainable(model)
    model.zero_grad(set_to_none=True)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jcfg.vocab, (2, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(params, batch)
    loss = tlm.loss_fn(model, tcfg, {"tokens": torch.as_tensor(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = jax.tree.leaves(convert.lm_to_numpy(model, "grad"))
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert all(np.isfinite(g).all() for g in got)
    if S != 256:
        close(got, want, 1e-4, f"S={S}")
        tlm.set_trainable(model, False)
        return
    finite = [np.isfinite(w) for w in want]
    assert not all(f.all() for f in finite)
    close([g[f] for g, f in zip(got, finite)],
          [w[f] for w, f in zip(want, finite)], 1e-4, "S=256, finite")
    monkeypatch.setitem(perf._FLAGS, "mlstm_chunked", False)
    _, seq = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(params, batch)
    close(got, jax.tree.leaves(seq), 5e-4, "S=256, sequential cell")
    tlm.set_trainable(model, False)
