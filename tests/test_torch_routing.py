"""Parity of the port's routing engine with repro.core.routing: binning with
capacity drops, plans (device and host), payload phases with a shrinking
active mask, reply alignment, and the coalescing helpers. Bit-exact,
including the reply words of undelivered ops (garbage by contract, but the
same garbage).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import routing as jr
from repro_torch.core import routing as tr
from torch_parity import same, torch_one_thread, tt  # noqa: F401


def _batch(seed, P, n, W, hot=False):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, P, (P, n)).astype(np.int32)
    if hot:
        dst[:, : n // 2] = 0
    payload = rng.integers(-100, 100, (P, n, W)).astype(np.int32)
    valid = rng.random((P, n)) > 0.2
    return dst, payload, valid


@pytest.mark.parametrize("P,n,cap,hot", [(4, 12, 12, False), (3, 10, 2, True),
                                         (4, 16, 5, True)])
def test_bin_by_dest_matches_jax(P, n, cap, hot):
    dst, payload, valid = _batch(P * n + cap, P, n, 3, hot)
    bj = jax.jit(jax.vmap(lambda d, p, v: jr.bin_by_dest(d, p, P, cap, v)))(
        jnp.asarray(dst), jnp.asarray(payload), jnp.asarray(valid))
    bt = tr.bin_by_dest(tt(dst), tt(payload), P, cap, tt(valid))
    for f in ("buf", "mask", "op_slot", "op_ok", "dropped"):
        same(getattr(bt, f), getattr(bj, f), f)


@pytest.mark.parametrize("cap", [None, 3])
def test_route_and_replies_match_jax(cap):
    P, n, W = 4, 12, 2
    dst, payload, valid = _batch(21, P, n, W, hot=True)
    c = n if cap is None else cap
    rj = jr.route(jnp.asarray(dst), jnp.asarray(payload), c,
                  jnp.asarray(valid))
    rt = tr.route(tt(dst), tt(payload), c, tt(valid))
    for f in ("at_owner", "mask", "op_slot", "op_ok", "dropped"):
        same(getattr(rt, f), getattr(rj, f), f)
    # owners answer with a function of the request; replies come home
    rep_j = jr.route_replies(rj, rj.at_owner * 7 + 1, jnp.asarray(dst))
    rep_t = tr.route_replies(rt, rt.at_owner * 7 + 1, tt(dst))
    same(rep_t, rep_j, "replies")


def test_plans_match_jax_and_host_mirror():
    P, n, W = 4, 10, 3
    dst, payload, valid = _batch(5, P, n, W, hot=True)
    pj = jr.make_plan(jnp.asarray(dst), jnp.asarray(valid), cap=4)
    pt = tr.make_plan(tt(dst), tt(valid), cap=4)
    pn = tr.make_plan_np(dst, valid, cap=4, device="cpu")
    for f in ("dst_eff", "op_slot", "op_ok", "mask", "dropped"):
        same(getattr(pt, f), getattr(pj, f), f)
        same(getattr(pn, f), getattr(pj, f), f)
    # a payload phase against the plan, with a shrinking active mask
    active = valid & (np.arange(n) % 3 != 0)
    rj = jr.route_with_plan(pj, jnp.asarray(payload), jnp.asarray(active))
    rt = tr.route_with_plan(pt, tt(payload), tt(active))
    for f in ("at_owner", "mask", "op_ok"):
        same(getattr(rt, f), getattr(rj, f), f)
    fj, mj = jr.flatten_owner_view(rj)
    ft, mt = tr.flatten_owner_view(rt)
    same(ft, fj)
    same(mt, mj)
    same(tr.unflatten_owner_view(ft, P, 4), jr.unflatten_owner_view(fj, P, 4))


def test_coalescing_helpers_match_jax():
    """Runs over (dst, off[, match]) with invalid rows, reply fan-out, the
    FAO folds and last-writer combine."""
    P, n = 3, 16
    rng = np.random.default_rng(9)
    dst = rng.integers(0, 2, (P, n)).astype(np.int32)
    off = rng.integers(0, 3, (P, n)).astype(np.int32)
    match = rng.integers(0, 2, (P, n, 2)).astype(np.int32)
    valid = rng.random((P, n)) > 0.2
    for m in (None, match):
        cj = jax.jit(jr.coalesce)(jnp.asarray(dst), jnp.asarray(off),
                                  None if m is None else jnp.asarray(m),
                                  jnp.asarray(valid))
        ct = tr.coalesce(tt(dst), tt(off), None if m is None else tt(m),
                         tt(valid))
        for f in ("rep", "leader", "pos", "order", "run_first", "rows_in",
                  "rows_out"):
            same(getattr(ct, f), getattr(cj, f), f)
        x = rng.integers(-9, 9, (P, n, 2)).astype(np.int32)
        same(tr.lead(ct, tt(x)), jax.jit(jr.lead)(cj, jnp.asarray(x)))
        same(tr.coalesce_last(ct, tt(x)),
             jax.jit(jr.coalesce_last)(cj, jnp.asarray(x)))
        operand = rng.integers(-2 ** 31, 2 ** 31, (P, n)).astype(np.int32)
        for kind, binop, ident in ((3, lambda a, b: a + b, 0),
                                   (4, lambda a, b: a | b, 0),
                                   (5, lambda a, b: a & b, -1),
                                   (6, lambda a, b: a ^ b, 0)):
            comb_j, pre_j = jax.jit(jr.coalesce_fold, static_argnums=(2, 3))(
                cj, jnp.asarray(operand), binop, ident)
            comb_t, pre_t = tr.coalesce_fold(ct, tt(operand), kind)
            same(comb_t, comb_j, f"combined kind {kind}")
            same(pre_t, pre_j, f"prefix kind {kind}")
    pj = jr.coalesce_plan(jnp.asarray(dst), jnp.asarray(off),
                          valid=jnp.asarray(valid), cap=n)
    pt = tr.coalesce_plan(tt(dst), tt(off), valid=tt(valid), cap=n)
    same(pt.plan.mask, pj.plan.mask)
    same(pt.co.rep, pj.co.rep)


def test_exchange_is_a_transpose_and_hook_sees_each_phase():
    seen = []
    x = tt(np.arange(24).reshape(2, 3, 4))
    with tr.sharding_hook(lambda t, role: (seen.append(role), t)[1]):
        y = tr.exchange(x, "req")
    same(y, np.swapaxes(np.arange(24).reshape(2, 3, 4), 0, 1))
    assert seen == ["req_pre", "req_post"]
    assert tr.exchange(x).is_contiguous()


def test_negative_destination_matches_jax():
    """A valid op with a negative destination rank is delivered where JAX's
    scatter puts it: -1 wraps to rank P-1 (and meets that rank's own ops at
    the same slot, where the later op in sorted order wins); below -P it is
    dropped from the buffer though op_ok holds, exactly as in JAX."""
    P, cap = 3, 3
    dst = np.array([[0, -1, 1, -1, 2, -4, 3, -2, 2, 2, -3, -1],
                    [-1, -1, -1, -1, 2, 2, 0, -5, 1, -2, 0, 2]], np.int32)
    payload = (np.arange(24, dtype=np.int32).reshape(2, 12, 1) + 10)
    valid = np.ones(dst.shape, bool)
    valid[0, 3] = valid[1, 6] = False
    bj = jax.jit(jax.vmap(lambda d, p, v: jr.bin_by_dest(d, p, P, cap, v)))(
        jnp.asarray(dst), jnp.asarray(payload), jnp.asarray(valid))
    bt = tr.bin_by_dest(tt(dst), tt(payload), P, cap, tt(valid))
    for f in ("buf", "mask", "op_slot", "op_ok", "dropped"):
        same(getattr(bt, f), getattr(bj, f), f)
    # op 1 (-1) is delivered but loses slot 0 of rank 2 to op 4 (rank 2)
    assert bool(bt.op_ok[0, 1]) and int(bt.buf[0, 2, 0, 0]) == 10 + 4
