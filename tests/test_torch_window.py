"""Parity of the port's window with repro.core.window on its default XLA
lane: the owner appliers, and the one-sided ops put, get, cas, fao,
cas_put, cas_put_publish and fao_get, each plain, against a route plan,
and coalesced. Bit-exact on the replies (including the garbage words of
undelivered ops) and on the window after the op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import routing as jr
from repro.core import window as jw
from repro_torch.core import routing as tr
from repro_torch.core import window as tw
from torch_parity import jit, same, torch_one_thread, tt  # noqa: F401

P, N, L = 4, 10, 48
j_put = jit(jw.rdma_put, "coalesce")
j_get = jit(jw.rdma_get, "width", "coalesce")
j_fao = jit(jw.rdma_fao, "kind", "coalesce")
j_cas = jit(jw.rdma_cas, "coalesce")
j_cas_put = jit(jw.rdma_cas_put, "coalesce")
j_cas_put_pub = jit(jw.rdma_cas_put_publish, "coalesce")
j_fao_get = jit(jw.rdma_fao_get, "kind", "width", "coalesce")


def jv(fn):
    """A per-owner JAX applier, vmapped over owners and jitted."""
    return jax.jit(jax.vmap(fn))


def _setup(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(-3, 4, (P, L)).astype(np.int32)
    dst = rng.integers(0, P, (P, N)).astype(np.int32)
    dst[:, :4] = 1                                   # a hot owner
    off = rng.integers(0, 6, (P, N)).astype(np.int32)  # repeated words
    valid = rng.random((P, N)) > 0.2
    return rng, data, dst, off, valid


def test_appliers_match_jax():
    """apply_fao_local (every kind, int32 wrap), apply_cas_local,
    apply_put_local, gather_local, apply_cas_put_local and
    apply_fao_get_local, owner-batched vs vmapped."""
    rng, data, _, _, _ = _setup(1)
    m = 24
    off = rng.integers(0, 8, (P, m)).astype(np.int32)
    mask = rng.random((P, m)) > 0.25
    operand = rng.integers(-2 ** 31, 2 ** 31, (P, m)).astype(np.int32)
    jd, td = jnp.asarray(data), tt(data)
    for kind in (3, 4, 5, 6):
        oj, nj = jv(lambda l, o, a, k: jw.apply_fao_local(
            l, o, a, k, kind))(jd, jnp.asarray(off), jnp.asarray(operand),
                               jnp.asarray(mask))
        ot, nt = tw.apply_fao_local(td, tt(off), tt(operand), tt(mask), kind)
        same(ot, oj, f"fao old {kind}")
        same(nt, nj, f"fao local {kind}")
    cmp = rng.integers(-3, 4, (P, m)).astype(np.int32)
    new = rng.integers(-3, 4, (P, m)).astype(np.int32)
    oj, nj = jv(jw.apply_cas_local)(jd, jnp.asarray(off),
                                          jnp.asarray(cmp), jnp.asarray(new),
                                          jnp.asarray(mask))
    ot, nt = tw.apply_cas_local(td, tt(off), tt(cmp), tt(new), tt(mask))
    same(ot, oj)
    same(nt, nj)
    vals = rng.integers(0, 99, (P, m, 3)).astype(np.int32)
    poff = rng.integers(-2, L, (P, m)).astype(np.int32)
    same(tw.apply_put_local(td, tt(poff), tt(vals), tt(mask)),
         jv(jw.apply_put_local)(jd, jnp.asarray(poff),
                                      jnp.asarray(vals), jnp.asarray(mask)))
    same(tw.gather_local(td, tt(poff), 3),
         jv(lambda l, o: jw.gather_local(l, o, 3))(
             jd, jnp.asarray(poff)))
    # fused appliers on engine-shaped batches: claims on flag words 3k,
    # puts at 3k+1 (disjoint rows), flips on the claimed flags
    flag = 3 * rng.integers(0, 8, (P, m)).astype(np.int32)
    data0 = np.zeros((P, L), np.int32)
    cas_new = np.full((P, m), 1, np.int32)
    flip = np.full((P, m), 3, np.int32)
    oj, nj = jv(jw.apply_cas_put_local)(
        jnp.asarray(data0), jnp.asarray(flag), jnp.zeros((P, m), jnp.int32),
        jnp.asarray(cas_new), jnp.asarray(flag + 1),
        jnp.asarray(vals[..., :2]), jnp.asarray(flip), jnp.asarray(mask))
    ot, nt = tw.apply_cas_put_local(
        tt(data0), tt(flag), tt(np.zeros((P, m))), tt(cas_new),
        tt(flag + 1), tt(vals[..., :2]), tt(flip), tt(mask))
    same(ot, oj)
    same(nt, nj)
    oj, gj, nj = jv(lambda l, o, a, g, mm: jw.apply_fao_get_local(
        l, o, a, 3, g, 3, mm))(jd, jnp.asarray(off), jnp.asarray(operand),
                               jnp.asarray(poff), jnp.asarray(mask))
    ot, gt, nt = tw.apply_fao_get_local(td, tt(off), tt(operand), 3,
                                        tt(poff), 3, tt(mask))
    same(ot, oj)
    same(gt, gj)
    same(nt, nj)


MODES = ["plain", "plan", "coalesce", "coalesced_plan"]


def _plans(mode, dst, off, valid, match=None):
    """(jax plan/coalesce kwargs, port plan/coalesce kwargs) for a mode."""
    if mode == "plain":
        return {}, {}
    if mode == "coalesce":
        return {"coalesce": True}, {"coalesce": True}
    if mode == "plan":
        return ({"plan": jr.make_plan(jnp.asarray(dst), jnp.asarray(valid))},
                {"plan": tr.make_plan(tt(dst), tt(valid))})
    mj = None if match is None else jnp.asarray(match)
    mt = None if match is None else tt(match)
    return ({"plan": jr.coalesce_plan(jnp.asarray(dst), jnp.asarray(off),
                                      match=mj, valid=jnp.asarray(valid))},
            {"plan": tr.coalesce_plan(tt(dst), tt(off), match=mt,
                                      valid=tt(valid))})


@pytest.mark.parametrize("mode", MODES)
def test_put_get_match_jax(mode):
    rng, data, dst, off, valid = _setup(2)
    vals = rng.integers(0, 50, (P, N, 2)).astype(np.int32)
    kj, kt = _plans(mode, dst, off, valid)
    wj = j_put(jw.Window(jnp.asarray(data)), jnp.asarray(dst),
               jnp.asarray(off), jnp.asarray(vals), valid=jnp.asarray(valid),
               **kj)
    wt = tw.rdma_put(tw.Window(tt(data)), tt(dst), tt(off), tt(vals),
                     valid=tt(valid), **kt)
    same(wt.data, wj.data, "put")
    gj = j_get(wj, jnp.asarray(dst), jnp.asarray(off), width=3,
               valid=jnp.asarray(valid), **kj)
    gt = tw.rdma_get(wt, tt(dst), tt(off), 3, valid=tt(valid), **kt)
    same(gt, gj, "get")


@pytest.mark.parametrize("mode", MODES)
def test_fao_cas_match_jax(mode):
    rng, data, dst, off, valid = _setup(3)
    operand = rng.integers(-5, 5, (P, N)).astype(np.int32)
    kj, kt = _plans(mode, dst, off, valid)
    win_j, win_t = jw.Window(jnp.asarray(data)), tw.Window(tt(data))
    for kind in (jw.AmoKind.FAA, jw.AmoKind.FXOR):
        oj, win_j = j_fao(win_j, jnp.asarray(dst), jnp.asarray(off),
                          jnp.asarray(operand), kind=kind,
                          valid=jnp.asarray(valid), **kj)
        ot, win_t = tw.rdma_fao(win_t, tt(dst), tt(off), tt(operand),
                                int(kind), valid=tt(valid), **kt)
        same(ot, oj, f"fao {kind}")
        same(win_t.data, win_j.data)
    cmp = rng.integers(-2, 3, (P, N)).astype(np.int32)
    new = cmp + 1
    kj, kt = _plans(mode, dst, off, valid, np.stack([cmp, new], -1))
    oj, win_j = j_cas(win_j, jnp.asarray(dst), jnp.asarray(off),
                      jnp.asarray(cmp), jnp.asarray(new),
                      valid=jnp.asarray(valid), **kj)
    ot, win_t = tw.rdma_cas(win_t, tt(dst), tt(off), tt(cmp), tt(new),
                            valid=tt(valid), **kt)
    same(ot, oj, "cas")
    same(win_t.data, win_j.data)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("publish", [False, True])
def test_cas_put_match_jax(mode, publish):
    """Fused claims as the hash table issues them: CAS EMPTY->RESERVED on
    flag words, the record at flag+1, the publish flip."""
    rng, _, dst, _, valid = _setup(4)
    rec_w = 4
    data = np.zeros((P, L), np.int32)
    data[:, ::rec_w] = rng.choice([0, 0, 2], (P, L // rec_w))
    flag = rec_w * rng.integers(0, L // rec_w, (P, N)).astype(np.int32)
    vals = rng.integers(1, 9, (P, N, 3)).astype(np.int32)
    vals[:, 1] = vals[:, 0]                 # identical rows to coalesce
    flag[:, 1], dst[:, 1] = flag[:, 0], dst[:, 0]
    desc = np.concatenate([np.zeros((P, N, 1), np.int32),
                           np.ones((P, N, 1), np.int32),
                           flag[..., None] + 1, np.full((P, N, 1), 3),
                           vals], -1).astype(np.int32)
    kj, kt = _plans(mode, dst, flag, valid, desc)
    args_j = (jw.Window(jnp.asarray(data)), jnp.asarray(dst),
              jnp.asarray(flag), 0, 1, jnp.asarray(flag + 1),
              jnp.asarray(vals))
    args_t = (tw.Window(tt(data)), tt(dst), tt(flag), 0, 1, tt(flag + 1),
              tt(vals))
    if publish:
        oj, wj = j_cas_put_pub(*args_j, 3, valid=jnp.asarray(valid), **kj)
        ot, wt = tw.rdma_cas_put_publish(*args_t, 3, valid=tt(valid), **kt)
    else:
        oj, wj = j_cas_put(*args_j, valid=jnp.asarray(valid), **kj)
        ot, wt = tw.rdma_cas_put(*args_t, valid=tt(valid), **kt)
    same(ot, oj, "old")
    same(wt.data, wj.data, "window")


@pytest.mark.parametrize("mode", MODES)
def test_fao_get_match_jax(mode):
    """The C_RW find's fused read-lock + record gather."""
    rng, data, dst, _, valid = _setup(5)
    rec_w = 4
    flag = rec_w * rng.integers(0, 3, (P, N)).astype(np.int32)
    unit = np.full((P, N), 256, np.int32)
    kj, kt = _plans(mode, dst, flag, valid, flag[..., None])
    oj, gj, wj = j_fao_get(jw.Window(jnp.asarray(data)), jnp.asarray(dst),
                           jnp.asarray(flag), jnp.asarray(unit),
                           kind=jw.AmoKind.FAA, get_off=jnp.asarray(flag),
                           width=rec_w, valid=jnp.asarray(valid), **kj)
    ot, gt, wt = tw.rdma_fao_get(tw.Window(tt(data)), tt(dst), tt(flag),
                                 tt(unit), 3, tt(flag), rec_w,
                                 valid=tt(valid), **kt)
    same(ot, oj, "old")
    same(gt, gj, "gathered")
    same(wt.data, wj.data, "window")


def test_phase_log_records_tagged_phases():
    _, data, dst, off, valid = _setup(6)
    tw.drain_phase_log()
    with tw.decision_scope("arm"), tw.slot_scope(1, 7):
        tw.rdma_get(tw.Window(tt(data)), tt(dst), tt(off), 1,
                    valid=tt(valid), coalesce=True)
    log = tw.drain_phase_log()
    assert [(r, d) for r, d, _ in log] == [("get", "arm")]
    info = log[0][2]
    assert info["slot"] == 1 and info["seq"] == 7 and info["coalesced"]
    assert tw.drain_phase_log() == []
