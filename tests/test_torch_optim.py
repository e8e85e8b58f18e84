"""Parity of the port's optimizers (repro_torch.optim) with the JAX
package's on the CPU: AdamW and Adafactor on trees with 1-D and >= 2-D
leaves in float32 and bfloat16, the warm-up cosine schedule, and global-
norm clipping. The same numpy leaves go to both; the port's functions
take them as flat lists in jax.tree's order and update in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from torch_parity import torch_one_thread  # noqa: F401

SHAPES = [(7,), (3, 5), (2, 4, 6), (1, 9)]


def leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]


def to_t(xs, dtype):
    return [torch.as_tensor(x).to(dtype) for x in xs]


def to_j(xs, dtype):
    return [jnp.asarray(x, dtype) for x in xs]


def step_tol(dtype):
    """f32: 1e-6 relative (the same f32 ops; XLA may fuse a multiply-add
    and its pow differs from torch's in the last place); bf16: one step of
    bf16 (2**-7 relative), since a last-place f32 difference can move the
    rounding of the new weight by one step."""
    return (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
            else dict(rtol=2.0 ** -7, atol=1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_update_matches_jax(kind, dtype):
    """Three updates of `kind` from its init on the same grads and
    params: the new params (in their dtype) and every state leaf."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    params = leaves(0)
    jp, tp = to_j(params, jdt), to_t(params, tdt)
    js = getattr(jopt, f"{kind}_init")(jp)
    ts = getattr(topt, f"{kind}_init")(tp)
    for step in range(3):
        grads = leaves(10 + step, scale=10.0 ** -step)
        lr = 1e-2 / (step + 1)
        jp, js = getattr(jopt, f"{kind}_update")(to_j(grads, jnp.float32),
                                                 js, jp, jnp.float32(lr))
        tp, ts = getattr(topt, f"{kind}_update")(to_t(grads, torch.float32),
                                                 ts, tp, lr)
        for a, b in zip(tp, jp):
            assert a.dtype == tdt
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       **step_tol(dtype))
        for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-12)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_adafactor_factors_stacked_leaves():
    """A 1-D leaf stacked over groups is 2-D, and Adafactor factors it as
    JAX does: row and column slots of a (2, 7) leaf, none of a (7,)."""
    st = topt.adafactor_init([torch.zeros(2, 7), torch.zeros(7)])
    assert set(st["slots"][0]) == {"vr", "vc"}
    assert tuple(st["slots"][0]["vr"].shape) == (2,)
    assert tuple(st["slots"][0]["vc"].shape) == (7,)
    assert set(st["slots"][1]) == {"v"}


def test_warmup_cosine_matches_jax():
    """Every step from 0 past the horizon: warm-up, cosine, floor; the
    same float32 value (within one f32 step of the cosine)."""
    js = jopt.warmup_cosine(3e-4, 10, 50)
    ts = topt.warmup_cosine(3e-4, 10, 50)
    for step in range(0, 60):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=2e-7)
    assert ts(0) == 0.0 and ts(60) == pytest.approx(3e-5, rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipped (max_norm below the norm) and not (above): the norm and
    every clipped leaf within 1e-6."""
    g = leaves(3)
    jg, jn = jopt.clip_by_global_norm(to_j(g, jnp.float32), max_norm)
    tg, tn = topt.clip_by_global_norm(to_t(g, torch.float32), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_make_optimizer_clips_then_steps():
    """make_optimizer's update: the returned norm is the unclipped one,
    and a second optimizer fed the clipped grads by hand agrees."""
    sched = topt.warmup_cosine(1e-2, 2, 10)
    init, update = topt.make_optimizer("adamw", sched, max_grad_norm=0.1)
    p1 = to_t(leaves(0), torch.float32)
    p2 = [p.clone() for p in p1]
    g = to_t(leaves(5), torch.float32)
    want_norm = float(torch.sqrt(sum((x * x).sum() for x in g)))
    s1, s2 = init(p1), topt.adamw_init(p2)
    clipped, _ = topt.clip_by_global_norm([x.clone() for x in g], 0.1)
    _, _, gn = update(g, s1, p1, 3)
    topt.adamw_update(clipped, s2, p2, sched(3))
    assert float(gn) == pytest.approx(want_norm, rel=1e-6)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
