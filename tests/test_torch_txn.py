"""The transaction engine of the port (`repro_torch.core.txn`) on the CPU:
the serializability conformance harness.

Parity with the JAX package, bit for bit (integer results): the plain
lanes `kernels.ref.txn_group_apply` (on `lane_cases.txn_group_apply_cases`,
the inputs chip_smoke.py's phase 1 holds kernel B9 to) and `txn_apply`
against the JAX oracles; `TxnEngine.run` on every arm against the JAX
engine (replies, order, rounds, aborts, saved reads, windows); `move`
against the JAX composite. Each runs at P = 4 with one or two batches.

The rest is tests/test_txn.py against the port's own ground truth instead
of the JAX streams: replaying the engine's committed order
(`TxnResult.order`) through the serial oracle (`serial_apply`) must give
its replies and final windows bit for bit, on every arm, coalesced or
pipelined, under contention; `find_serial_order` must find a witness, and
is itself pinned against hand-built histories.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as jam
from repro.core import hashtable as jht
from repro.core import txn as jtxn
from repro.core import window as jwin
from repro.core.types import AmoKind as JAmoKind
from repro.kernels import ref as jref
from repro_torch.core import adaptive as ad_mod
from repro_torch.core import am as am_mod
from repro_torch.core import hashtable as ht_mod
from repro_torch.core import queue as q_mod
from repro_torch.core import txn as txn_mod
from repro_torch.core import window as win_mod
from repro_torch.core.txn import (Txn, TxnEngine, find_serial_order,
                                  serial_apply)
from repro_torch.core.types import AmoKind, OpStats
from repro_torch.kernels import lane_cases
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from torch_parity import npy, same, torch_one_thread, tt  # noqa: F401

P = 4
L = 32
VW = 2
ARMS = ["rdma", "rdma_fused", "am", "am_pt", "auto"]


def _engine(**kw):
    return TxnEngine(P, am_engine=am_mod.AMEngine(P), **kw)


def _window(rng, lo=-50, hi=50):
    return win_mod.Window(data=torch.as_tensor(
        rng.integers(lo, hi, size=(P, L)).astype(np.int32)))


def _random_txn(rng, nops=None, chain_p=0.25, space="ht", mod=txn_mod,
                kinds=AmoKind):
    """A contending SPMD txn batch: hot offsets (0..3) mixed with cold
    ones, a random op mix, some chain guards and per-op participation
    masks. `mod` / `kinds` stage it in either package."""
    t = mod.Txn(P)
    n = int(rng.integers(3, 7)) if nops is None else nops
    for _ in range(n):
        kind = int(rng.integers(0, 4))
        hot = rng.random() < 0.5
        dst = rng.integers(0, P, P)
        off = rng.integers(0, 4, P) if hot else rng.integers(4, L, P)
        valid = None if rng.random() < 0.7 else rng.random(P) > 0.3
        if kind == 0:
            t.put(dst, off, rng.integers(-9, 9, P), space=space, valid=valid)
        elif kind == 1:
            t.get(dst, off, space=space, valid=valid)
        elif kind == 2:
            t.cas(dst, off, rng.integers(-50, 50, P), rng.integers(-9, 9, P),
                  space=space, chain=(rng.random() < chain_p), valid=valid)
        else:
            t.fao(dst, off, rng.integers(-3, 4, P),
                  kinds(int(rng.integers(3, 7))), space=space, valid=valid)
    return t


def _assert_conformant(init, txn, res, witness=True):
    """The engine's own serial order replays bit for bit, and (optionally)
    the blind checker finds a witness for the observed history."""
    ranks = [p for _, p in res.order]
    replies, st = serial_apply(init, txn, ranks)
    for s in init:
        assert np.array_equal(st[s], npy(res.wins[s].data)), s
    assert np.array_equal(replies, res.replies)
    has = txn.has_ops()
    assert np.array_equal(res.committed[has], res.chain_ok[has])
    assert not res.replies[~res.chain_ok].any()
    if witness:
        final = {s: npy(res.wins[s].data) for s in init}
        assert find_serial_order(init, txn, res.committed, res.replies,
                                 final) is not None


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------
_CASES = lane_cases.txn_group_apply_cases()


@pytest.mark.parametrize("i", range(len(_CASES)),
                         ids=[c[0] for c in _CASES])
def test_txn_group_apply_matches_jax(i):
    """The plain lane against the JAX oracle (vmapped over owners) on the
    B9 edge cases, bit for bit."""
    label, _, (local, ops, mask), kw = _CASES[i]
    rep, loc2 = kref.txn_group_apply(tt(local), tt(ops), tt(mask), **kw)
    jrep, jloc = jax.jit(jax.vmap(
        lambda a, b, c: jref.txn_group_apply(a, b, c, **kw)))(
        jnp.asarray(local), jnp.asarray(ops), jnp.asarray(mask))
    same(rep, jrep, label)
    same(loc2, jloc, label)
    rep2, loc3 = kops.txn_group_apply(tt(local), tt(ops), tt(mask), **kw)
    same(rep2, rep, label)
    same(loc3, loc2, label)


def test_txn_apply_matches_jax():
    """The whole-window serial oracle, with offsets outside the window and
    failing guards."""
    rng = np.random.default_rng(0)
    Pw, Lw, T, m = 3, 8, 5, 4
    for _ in range(3):
        data = rng.integers(-4, 4, (Pw, Lw)).astype(np.int32)
        dst = rng.integers(0, Pw, (T, m)).astype(np.int32)
        ops = np.stack([rng.choice([0, 1, 2, 3, -1, -9, Lw, -Lw * Pw - 1],
                                   (T, m)),
                        rng.integers(0, 8, (T, m)),
                        rng.integers(-4, 4, (T, m)),
                        rng.integers(-4, 4, (T, m))], -1).astype(np.int32)
        mask = rng.random((T, m)) < 0.8
        chain = (rng.random((T, m)) < 0.4).astype(np.int32)
        got = kref.txn_apply(*(tt(x) for x in (data, dst, ops, mask, chain)))
        want = jref.txn_apply(*(jnp.asarray(x)
                                for x in (data, dst, ops, mask, chain)))
        for a, b in zip(got, want):
            same(a, b)


@pytest.mark.parametrize("arm", ARMS)
def test_engine_matches_jax(arm):
    """A contending batch (7 rounds, 6 aborts) on each package's engine:
    replies, commit flags, order, rounds, aborts, saved reads, the arm
    auto picked and the window, bit for bit."""
    init = np.random.default_rng(5).integers(-50, 50, (P, L)).astype(
        np.int32)
    eng, jeng = _engine(), jtxn.TxnEngine(P, am_engine=jam.AMEngine(P))
    w = win_mod.Window(data=torch.as_tensor(init))
    jw = jwin.Window(data=jnp.asarray(init))
    for trial in range(1):
        t = _random_txn(np.random.default_rng(trial))
        jt = _random_txn(np.random.default_rng(trial), mod=jtxn,
                         kinds=JAmoKind)
        res, jres = eng.run(w, t, arm=arm), jeng.run(jw, jt, arm=arm)
        w, jw = res.wins["ht"], jres.wins["ht"]
        same(res.replies, jres.replies, (arm, trial))
        same(res.committed, jres.committed)
        same(res.chain_ok, jres.chain_ok)
        assert res.order == jres.order
        for f in ("rounds", "aborts", "chain_aborts", "saved_reads", "arm",
                  "commits"):
            assert getattr(res, f) == getattr(jres, f), (arm, trial, f)
        same(w.data, jw.data, (arm, trial, "window"))
    jax.clear_caches()


def _move_table(pkg, rng):
    keys = rng.choice(5000, size=(P, 6), replace=False).astype(np.int32)
    vals = rng.integers(-99, 99, size=(P, 6, VW)).astype(np.int32)
    if pkg == "jax":
        ht = jht.make_hashtable(P, nslots=64, val_words=VW)
        ht, ok, _ = jht.insert_rdma(ht, jnp.asarray(keys), jnp.asarray(vals))
    else:
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        ht, ok, _ = ht_mod.insert_rdma(ht, keys, vals)
    assert npy(ok).all()
    return ht, keys


def test_move_matches_jax():
    """`move`, one clean batch and one contended on a shared destination,
    gives the JAX composite's flags, values and window (on the am arm:
    the JAX package's eager one-sided rounds take seconds each).
    `pop_then_insert` is held to the JAX composite under a fault plan in
    tests/test_torch_faults.py."""
    ht, keys = _move_table("torch", np.random.default_rng(41))
    jht_, _ = _move_table("jax", np.random.default_rng(41))
    eng, jeng = _engine(), jtxn.TxnEngine(P, am_engine=jam.AMEngine(P))
    for k1, k2 in ((keys[:, 0], keys[:, 0] + 100000),
                   (keys[:, 1], np.full(P, 424242, np.int32))):
        ht, moved, mv = ht_mod.move(ht, k1, k2, eng, arm="am")
        jht_, jmoved, jmv = jht.move(jht_, k1, k2, jeng, arm="am")
        same(moved, jmoved)
        same(mv, jmv)
        same(ht.win.data, jht_.win.data, "window")
    assert moved.sum() == 1
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Kernel level: the owner lane against independent serial references
# ---------------------------------------------------------------------------
class TestGroupApplyKernel:
    def _rows(self, rng, m, llen, ngroups, chain_p=0.3):
        ops = np.zeros((m, 6), np.int32)
        ops[:, 0] = rng.integers(0, llen, m)
        ops[:, 1] = rng.integers(0, 7, m)
        ops[:, 2] = rng.integers(-5, 6, m)
        ops[:, 3] = rng.integers(-5, 6, m)
        # contiguous gid runs, as flatten_owner_view produces
        ops[:, 4] = np.sort(rng.integers(0, ngroups, m))
        ops[:, 5] = (rng.random(m) < chain_p).astype(np.int32)
        mask = rng.random(m) > 0.15
        return ops, mask

    def _serial(self, local, ops, mask, ngroups):
        """Independent re-execution: groups all-or-nothing in op order,
        chain-failed groups as no-ops with zeroed replies."""
        st = np.asarray(local).copy()
        reply = np.zeros((len(ops), 2), np.int64)
        for g in range(ngroups):
            rows = [j for j in range(len(ops))
                    if ops[j, 4] == g and mask[j]]
            snap = st.copy()
            dead = False
            rep = {}
            for j in rows:
                off, code, a, b = (int(ops[j, 0]), int(ops[j, 1]),
                                   int(ops[j, 2]), int(ops[j, 3]))
                cur = int(st[off])
                if ops[j, 5] and code == txn_mod.OP_CAS and cur != a:
                    dead = True
                    break
                rep[j] = cur
                st[off] = txn_mod._new_val(cur, code, a, b)
            if dead:
                st = snap
            else:
                for j, old in rep.items():
                    reply[j] = (old, 1)
        return reply, st

    def test_matches_serial_reference(self):
        rng = np.random.default_rng(3)
        for trial in range(8):
            local = rng.integers(-9, 9, (1, 24)).astype(np.int32)
            ops, mask = self._rows(rng, 20, 24, ngroups=4)
            rep, loc2 = kref.txn_group_apply(tt(local), tt(ops[None]),
                                             tt(mask[None]), ngroups=4)
            want_rep, want_st = self._serial(local[0], ops, mask, 4)
            assert np.array_equal(npy(rep)[0], want_rep), trial
            assert np.array_equal(npy(loc2)[0], want_st), trial

    def test_batched_op_matches_per_owner(self):
        rng = np.random.default_rng(4)
        local = rng.integers(-9, 9, (P, 24)).astype(np.int32)
        ops = np.stack([self._rows(rng, 16, 24, 4)[0] for _ in range(P)])
        mask = rng.random((P, 16)) > 0.2
        rep_b, loc_b = kops.txn_group_apply(tt(local), tt(ops), tt(mask),
                                            ngroups=4)
        for p in range(P):
            rep_r, loc_r = kref.txn_group_apply(
                tt(local[p:p + 1]), tt(ops[p:p + 1]), tt(mask[p:p + 1]),
                ngroups=4)
            same(rep_b[p], rep_r[0])
            same(loc_b[p], loc_r[0])

    def test_chain_abort_is_all_or_nothing(self):
        local = np.arange(8, dtype=np.int32)[None]
        # group 0: put then an impossible chain guard -> whole group dead
        ops = np.array([[[0, txn_mod.OP_PUT, 0, 99, 0, 0],
                         [1, txn_mod.OP_CAS, -1, 7, 0, 1],
                         [2, txn_mod.OP_FAA, 5, 0, 1, 0]]], np.int32)
        rep, loc2 = kref.txn_group_apply(tt(local), tt(ops),
                                         torch.ones((1, 3), dtype=torch.bool),
                                         ngroups=2)
        rep, loc2 = npy(rep)[0], npy(loc2)[0]
        assert loc2[0] == 0 and loc2[1] == 1       # group 0 rolled back
        assert not rep[0].any() and not rep[1].any()
        assert loc2[2] == 7 and tuple(rep[2]) == (2, 1)  # group 1 applied

    def test_txn_apply_oracle_chain_abort(self):
        data = np.zeros((2, 8), np.int32)
        dst = np.array([[0, 1], [1, 1]], np.int32)
        ops = np.array([[[0, txn_mod.OP_PUT, 0, 5],
                         [3, txn_mod.OP_FAA, 2, 0]],
                        [[3, txn_mod.OP_CAS, 9, 1],   # guard fails
                         [4, txn_mod.OP_PUT, 0, 8]]], np.int32)
        mask = np.ones((2, 2), bool)
        chain = np.array([[0, 0], [1, 0]], np.int32)
        rep, ok, data2 = kref.txn_apply(*(tt(x) for x in (data, dst, ops,
                                                          mask, chain)))
        same(ok, [True, False])
        assert not npy(rep)[1].any()
        d2 = npy(data2)
        assert d2[0, 0] == 5 and d2[1, 3] == 2 and d2[1, 4] == 0


# ---------------------------------------------------------------------------
# Staging API
# ---------------------------------------------------------------------------
class TestStaging:
    def test_chain_requires_cas(self):
        t = Txn(P)
        with pytest.raises(ValueError, match="chain"):
            t._stage("ht", txn_mod.OP_PUT, 0, 0, chain=True)

    def test_fao_kind_validated(self):
        t = Txn(P)
        with pytest.raises(ValueError, match="fao kind"):
            t.fao(0, 0, 1, AmoKind.CAS)

    def test_spaces_first_touch_order(self):
        t = Txn(P)
        t.put(0, 0, 1, space="q")
        t.get(0, 1, space="ht")
        t.fao(0, 2, 1, space="q")
        assert t.spaces == ["q", "ht"]

    def test_multi_space_needs_dict(self):
        rng = np.random.default_rng(0)
        t = Txn(P)
        t.put(0, 0, 1, space="a")
        t.put(0, 0, 1, space="b")
        with pytest.raises(ValueError, match="multi-space"):
            _engine().run(_window(rng), t)

    def test_empty_txn_commits_trivially(self):
        rng = np.random.default_rng(0)
        res = _engine().run(_window(rng), Txn(P))
        assert res.committed.all() and res.rounds == 0 and res.order == []

    def test_opless_rank_not_in_order(self):
        rng = np.random.default_rng(1)
        t = Txn(P)
        t.fao(0, 0, 1, valid=np.arange(P) != 0)
        res = _engine().run(_window(rng), t)
        assert res.committed.all()
        assert 0 not in [p for _, p in res.order]


# ---------------------------------------------------------------------------
# Engine conformance: every arm, randomized contending streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arm", ARMS)
def test_conformance_random_streams(arm):
    rng = np.random.default_rng(100 + ARMS.index(arm))
    eng = _engine()
    win = _window(rng)
    for _ in range(4):
        init = {"ht": npy(win.data).copy()}
        t = _random_txn(rng)
        res = eng.run(win, t, arm=arm)
        assert res.arm in txn_mod.TXN_ARMS
        _assert_conformant(init, t, res)
        win = res.wins["ht"]


@pytest.mark.parametrize("arm", ["rdma", "am"])
def test_hot_word_contention_aborts_then_commits(arm):
    """Every rank FAAs the same word: locks force one winner a round,
    everyone commits eventually, and the abort and backoff counters show
    the contention."""
    rng = np.random.default_rng(7)
    eng = _engine()
    win = _window(rng)
    init = {"ht": npy(win.data).copy()}
    t = Txn(P)
    j = t.fao(1, 0, np.arange(P) + 1)
    t.get((np.arange(P) + 1) % P, 10 + np.arange(P))  # cold read set
    res = eng.run(win, t, arm=arm)
    assert res.committed.all() and res.chain_ok.all()
    assert res.aborts > 0 and 0.0 < res.abort_rate < 1.0
    assert res.rounds > 1 and res.commits == P
    assert res.saved_reads > 0
    final = int(npy(res.wins["ht"].data)[1, 0])
    assert final == txn_mod._wrap32(int(init["ht"][1, 0]) + P * (P + 1) // 2)
    run = int(init["ht"][1, 0])
    for p in [p for _, p in res.order]:
        assert res.replies[p, j] == np.int32(run)
        run += p + 1
    _assert_conformant(init, t, res)


def test_chain_abort_is_final_and_atomic():
    rng = np.random.default_rng(11)
    eng = _engine()
    win = _window(rng)
    init = {"ht": npy(win.data).copy()}
    t = Txn(P)
    # rank 2's guard can never pass (window values are < 50)
    cmp = np.where(np.arange(P) == 2, 999, init["ht"][0, 0])
    t.cas(0, 0, cmp, 77, chain=True)
    t.put(np.arange(P), 20, np.arange(P) + 1)
    res = eng.run(win, t, arm="rdma")
    assert not res.committed[2] and not res.chain_ok[2]
    assert not res.replies[2].any()
    assert npy(res.wins["ht"].data)[2, 20] == init["ht"][2, 20]
    _assert_conformant(init, t, res)


def test_intra_txn_read_after_write():
    rng = np.random.default_rng(12)
    t = Txn(P)
    t.put(np.arange(P), 5, 41)
    j = t.get(np.arange(P), 5)  # same word, later op: sees our own put
    res = _engine().run(_window(rng), t, arm="rdma")
    assert (res.replies[:, j] == 41).all()


def test_multi_space_conformance():
    rng = np.random.default_rng(13)
    eng = _engine()
    wa, wb = _window(rng), _window(rng)
    init = {"a": npy(wa.data).copy(), "b": npy(wb.data).copy()}
    for arm in ("rdma_fused", "am"):
        t = Txn(P)
        t.fao(0, 0, 1, space="a")
        t.cas(1, 0, init["b"][1, 0], -7, space="b", chain=False)
        t.get(np.arange(P), 3, space="a")
        t.put((np.arange(P) + 1) % P, 9, np.arange(P), space="b")
        res = eng.run({"a": wa, "b": wb}, t, arm=arm)
        assert res.committed.all()
        _assert_conformant(init, t, res)
        wa, wb = res.wins["a"], res.wins["b"]
        init = {"a": npy(wa.data).copy(), "b": npy(wb.data).copy()}


def test_coalesced_duplicate_reads_conformant():
    """rdma_fused ships duplicate (dst, off) READ rows once; lock probes
    are never merged, so duplicate hot reads stay serializable."""
    rng = np.random.default_rng(14)
    win = _window(rng)
    init = {"ht": npy(win.data).copy()}
    t = Txn(P)
    t.get(1, 4)                      # all P ranks read the same word
    t.get(1, 4)                      # twice
    t.fao(1, 4, 1)                   # and increment it
    res = _engine().run(win, t, arm="rdma_fused")
    assert res.committed.all()
    _assert_conformant(init, t, res)


# ---------------------------------------------------------------------------
# Pipelined submission (depth 2)
# ---------------------------------------------------------------------------
class TestPipelined:
    def _stream(self, rng, n=4):
        return [_random_txn(rng, chain_p=0.15) for _ in range(n)]

    def test_depth2_bit_exact_with_depth1(self):
        rng = np.random.default_rng(21)
        win0 = _window(rng)
        txn_seed = rng.integers(0, 2 ** 31)
        outs = []
        for depth in (1, 2):
            stream = self._stream(np.random.default_rng(txn_seed))
            outs.append(_engine().run_many(win0, stream, arm="rdma_fused",
                                           depth=depth))
        (r1, f1), (r2, f2) = outs
        same(f1["ht"].data, f2["ht"].data)
        for a, b in zip(r1, r2):
            assert np.array_equal(a.replies, b.replies)
            assert np.array_equal(a.committed, b.committed)

    def test_depth2_prefetch_saves_reads(self):
        """Txn k+1 reads words txn k never writes: the prefetched stamps
        stay valid and round 1 is served from the ReadSet."""
        rng = np.random.default_rng(22)
        win = _window(rng)
        stream = []
        for i in range(3):
            t = Txn(P)
            t.fao(np.arange(P), 2 * i, 1)      # disjoint write sets
            t.get(np.arange(P), 20 + 2 * i)    # disjoint cold reads
            stream.append(t)
        results, _ = _engine().run_many(win, stream, arm="rdma", depth=2)
        assert all(r.committed.all() for r in results)
        assert sum(r.saved_reads for r in results[1:]) > 0

    def test_depth2_conformant_per_txn(self):
        rng = np.random.default_rng(23)
        win = _window(rng)
        stream = self._stream(rng)
        init = {"ht": npy(win.data).copy()}
        results, final = _engine().run_many(win, stream, arm="rdma_fused",
                                            depth=2)
        st = init
        for t, res in zip(stream, results):
            _assert_conformant(st, t, res, witness=False)
            st = {"ht": npy(res.wins["ht"].data).copy()}
        assert np.array_equal(st["ht"], npy(final["ht"].data))


# ---------------------------------------------------------------------------
# Mixed single-op / txn streams
# ---------------------------------------------------------------------------
class TestMixedStreams:
    def test_single_ops_interleave_with_txns(self):
        """Single-word ops between engine rounds: the host loop is
        sequential, so the oracle is the same interleaving replayed."""
        rng = np.random.default_rng(31)
        eng = _engine()
        win = _window(rng)
        oracle = npy(win.data).copy()
        for step in range(4):
            dst = rng.integers(0, P, (P, 1)).astype(np.int32)
            off = rng.integers(0, L, (P, 1)).astype(np.int32)
            add = rng.integers(-5, 6, (P, 1)).astype(np.int32)
            _, win = win_mod.rdma_fao(win, tt(dst), tt(off), tt(add),
                                      AmoKind.FAA)
            np.add.at(oracle, (dst, off), add)
            t = _random_txn(rng)
            res = eng.run(win, t, arm=["rdma", "am"][step % 2])
            _assert_conformant({"ht": oracle.copy()}, t, res, witness=False)
            win = res.wins["ht"]
            _, st = serial_apply({"ht": oracle}, t,
                                 [p for _, p in res.order])
            oracle = st["ht"]
        assert np.array_equal(oracle, npy(win.data))

    def test_ht_inserts_between_moves(self):
        """insert_rdma batches interleave with move transactions on the
        same table; every surviving key reads back."""
        rng = np.random.default_rng(32)
        ht = ht_mod.make_hashtable(P, nslots=128, val_words=VW, device="cpu")
        eng = _engine()
        flat = rng.choice(np.arange(1, 9000), size=P * 8, replace=False)
        k1 = flat[:P * 4].reshape(P, 4).astype(np.int32)
        k2 = flat[P * 4:].reshape(P, 4).astype(np.int32)
        v1 = np.stack([k1 * 3 + 1, k1 * 3 + 2], -1).astype(np.int32)
        v2 = np.stack([k2 * 3 + 1, k2 * 3 + 2], -1).astype(np.int32)
        ht, ok, _ = ht_mod.insert_rdma(ht, k1, v1)
        assert bool(ok.all())
        src = k1[:, 0]
        dstk = src + 50000
        ht, moved, _ = ht_mod.move(ht, src, dstk, eng)
        assert moved.all()
        ht, ok2, _ = ht_mod.insert_rdma(ht, k2, v2)
        assert bool(ok2.all())
        _, f_old, _ = ht_mod.find_rdma(ht, src[:, None])
        assert not bool(f_old.any())
        _, f_new, v_new = ht_mod.find_rdma(ht, dstk[:, None])
        assert bool(f_new.all())
        same(npy(v_new)[:, 0], v1[:, 0])
        _, f2, got2 = ht_mod.find_rdma(ht, k2)
        assert bool(f2.all())
        same(got2, v2)


# ---------------------------------------------------------------------------
# Composites: atomicity pins
# ---------------------------------------------------------------------------
class TestMove:
    def _table(self, rng, nkeys=6):
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        keys = rng.choice(5000, size=(P, nkeys), replace=False).astype(
            np.int32)
        vals = rng.integers(-99, 99, size=(P, nkeys, VW)).astype(np.int32)
        ht, ok, _ = ht_mod.insert_rdma(ht, keys, vals)
        assert bool(ok.all())
        return ht, keys, vals

    @pytest.mark.parametrize("arm", ["rdma_fused", "am"])
    def test_move_relocates_atomically(self, arm):
        rng = np.random.default_rng(41)
        ht, keys, vals = self._table(rng)
        k1 = keys[:, 0]
        k2 = k1 + 100000
        ht2, moved, mv = ht_mod.move(ht, k1, k2, _engine(), arm=arm)
        assert moved.all()
        same(mv, vals[:, 0])
        _, f1, _ = ht_mod.find_rdma(ht2, k1[:, None])
        _, f2, v2 = ht_mod.find_rdma(ht2, k2[:, None])
        assert not bool(f1.any()) and bool(f2.all())
        same(npy(v2)[:, 0], mv)

    def test_aborted_move_leaves_both_shards_untouched(self):
        """k2 already present: the chain guard on its slot flag fails and
        nothing moves, both shards bit for bit as before."""
        rng = np.random.default_rng(42)
        ht, keys, _ = self._table(rng)
        snap = npy(ht.win.data).copy()
        ht2, moved, _ = ht_mod.move(ht, keys[:, 0], keys[:, 1], _engine())
        assert not moved.any()
        same(ht2.win.data, snap)

    def test_absent_source_fails_cleanly(self):
        rng = np.random.default_rng(43)
        ht, keys, _ = self._table(rng)
        ghost = keys[:, 0] + 777777
        snap = npy(ht.win.data).copy()
        ht2, moved, _ = ht_mod.move(ht, ghost, ghost + 1, _engine())
        assert not moved.any()
        same(ht2.win.data, snap)

    def test_contended_move_same_destination(self):
        """Every rank moves a different source to the same destination:
        one wins; losers abort atomically and their sources stay."""
        rng = np.random.default_rng(44)
        ht, keys, vals = self._table(rng)
        k1 = keys[:, 0]
        ht2, moved, _ = ht_mod.move(ht, k1, np.full(P, 424242, np.int32),
                                    _engine())
        assert moved.sum() == 1
        _, f1, v1 = ht_mod.find_rdma(ht2, k1[:, None])
        same(npy(f1)[:, 0], ~moved)
        loser = ~moved
        same(npy(v1)[loser, 0], vals[loser, 0])
        _, f2, v2 = ht_mod.find_rdma(ht2, np.full((P, 1), 424242, np.int32))
        assert bool(f2.all())
        winner = int(np.nonzero(moved)[0][0])
        same(npy(v2)[0, 0], vals[winner, 0])

    def test_probe_mirror_matches_the_window(self):
        """`_probe_np` on a numpy image and on the tensor (one gather)
        agree, and find the slots a find reaches."""
        rng = np.random.default_rng(45)
        ht, keys, _ = self._table(rng)
        data = npy(ht.win.data)
        for key in keys[:, 0].tolist() + [999999]:
            a = ht_mod._probe_np(data, P, 64, ht.rec_w, key, 8)
            b = ht_mod._probe_np(ht.win.data, P, 64, ht.rec_w, key, 8)
            assert a == b
            assert (a[1] >= 0) == (key != 999999)


class TestPopThenInsert:
    def _loaded(self, rng, n=2):
        q = q_mod.make_queue(P, host=1, capacity=32, val_words=VW,
                             device="cpu")
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        pv = rng.choice(3000, size=(P, n, VW), replace=False).astype(
            np.int32)
        q, pushed = q_mod.push_rdma(q, pv)
        assert bool(pushed.all())
        return q, ht, pv

    @pytest.mark.parametrize("arm", ["rdma_fused", "am"])
    def test_pop_lands_in_table(self, arm):
        rng = np.random.default_rng(51)
        q, ht, pv = self._loaded(rng)
        q2, ht2, popped, vals = q_mod.pop_then_insert(q, ht, _engine(),
                                                      arm=arm)
        assert popped.all()
        assert npy(q2.win.data)[q.host, q_mod.HEAD] == P
        _, f, got = ht_mod.find_rdma(ht2, vals[:, 0][:, None])
        assert bool(f.all())
        same(npy(got)[:, 0], vals)
        flat = pv.reshape(-1, VW)
        for v in vals:
            assert (flat == v).all(axis=1).any()
        assert len({tuple(v) for v in vals}) == P

    def test_empty_queue_pops_nothing(self):
        q = q_mod.make_queue(P, host=1, capacity=32, val_words=VW,
                             device="cpu")
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        snap_q, snap_h = npy(q.win.data).copy(), npy(ht.win.data).copy()
        q2, ht2, popped, _ = q_mod.pop_then_insert(q, ht, _engine())
        assert not popped.any()
        same(q2.win.data, snap_q)
        same(ht2.win.data, snap_h)

    def test_partial_queue_pops_exactly_available(self):
        rng = np.random.default_rng(53)
        q = q_mod.make_queue(P, host=1, capacity=32, val_words=VW,
                             device="cpu")
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        pv = rng.choice(3000, size=(1, 2, VW), replace=False).astype(
            np.int32)
        pushed_mask = np.broadcast_to((np.arange(P) == 0)[:, None], (P, 2))
        q, pushed = q_mod.push_rdma(q, np.ascontiguousarray(np.broadcast_to(
            pv, (P, 2, VW))),
                                    valid=pushed_mask)
        assert int(pushed.sum()) == 2
        q2, ht2, popped, vals = q_mod.pop_then_insert(q, ht, _engine())
        assert int(popped.sum()) == 2
        pk = vals[popped][:, 0]
        _, f, _ = ht_mod.find_rdma(ht2, np.broadcast_to(pk[None, :],
                                                        (P, pk.size)))
        assert bool(f.all())


# ---------------------------------------------------------------------------
# The checker itself
# ---------------------------------------------------------------------------
class TestChecker:
    def _xy_txns(self):
        """t0: read x, write y; t1: read y, write x (x = (0,0), y = (0,1));
        ranks 2, 3 stage nothing."""
        t = Txn(P)
        sel0 = np.arange(P) == 0
        sel1 = np.arange(P) == 1
        t.get(0, np.where(sel0, 0, 1), valid=sel0 | sel1)
        t.put(0, np.where(sel0, 1, 0), 1, valid=sel0 | sel1)
        return t

    def _xy_final(self):
        init = {"ht": np.zeros((P, L), np.int32)}
        final = {"ht": init["ht"].copy()}
        final["ht"][0, 0] = 1
        final["ht"][0, 1] = 1
        return init, final

    def test_rejects_write_skew_history(self):
        """Both txns read the pre-state and both committed: write skew."""
        init, final = self._xy_final()
        replies = np.zeros((P, 2), np.int32)
        assert find_serial_order(init, self._xy_txns(), np.ones(P, bool),
                                 replies, final) is None

    def test_accepts_serial_history(self):
        """t1's read observes t0's write: order (0, 1)."""
        init, final = self._xy_final()
        replies = np.zeros((P, 2), np.int32)
        replies[1, 0] = 1
        assert find_serial_order(init, self._xy_txns(), np.ones(P, bool),
                                 replies, final) == [0, 1]

    def test_aborted_txn_must_abort_at_its_position(self):
        """Two ranks guard CAS(0 -> 9) on one word: both succeeding is
        impossible; one winner and one abort is serializable."""
        t = Txn(P)
        t.cas(0, 0, 0, 9, chain=True, valid=np.arange(P) < 2)
        init = {"ht": np.zeros((P, L), np.int32)}
        replies = np.zeros((P, 1), np.int32)
        good = {"ht": init["ht"].copy()}
        good["ht"][0, 0] = 9
        both = np.array([True, True, False, False])
        assert find_serial_order(init, t, both, replies, good) is None
        one = np.array([True, False, False, False])
        assert find_serial_order(init, t, one, replies, good) == [0, 1]

    def test_rejects_wrong_final_state(self):
        t = Txn(P)
        t.fao(0, 0, 1, valid=np.arange(P) == 0)
        init = {"ht": np.zeros((P, L), np.int32)}
        bad = {"ht": init["ht"].copy()}
        bad["ht"][0, 0] = 5
        assert find_serial_order(init, t, np.array([True, False, False,
                                                    False]),
                                 np.zeros((P, 1), np.int32), bad) is None

    def test_finds_nontrivial_witness(self):
        """Rank 1's guard passes only against the pre-state, so 1 must
        precede 0."""
        t = Txn(P)
        t.cas(0, 0, np.where(np.arange(P) == 0, 7, 0),
              np.where(np.arange(P) == 0, 3, 7), chain=True,
              valid=np.arange(P) < 2)
        init = {"ht": np.zeros((P, L), np.int32)}
        final = {"ht": init["ht"].copy()}
        final["ht"][0, 0] = 3
        replies = np.zeros((P, 1), np.int32)
        replies[0, 0] = 7
        assert find_serial_order(init, t, np.array([True, True, False,
                                                    False]),
                                 replies, final) == [1, 0]


# ---------------------------------------------------------------------------
# Adaptive integration: the abort-rate EWMA
# ---------------------------------------------------------------------------
def test_abort_ewma_feeds_adaptive():
    rng = np.random.default_rng(61)
    auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
    eng = TxnEngine(P, am_engine=auto.am_engine, adaptive=auto)
    t = Txn(P)
    t.fao(0, 0, 1)                             # maximally contended
    res = eng.run(_window(rng), t, arm="rdma")
    assert res.aborts > 0 and auto.abort_ewma > 0.0
    s = auto._fault_stats(OpStats())
    assert s.abort_rate == pytest.approx(min(0.95, auto.abort_ewma))
    res2 = eng.run(res.wins["ht"], t, arm="auto")
    assert res2.committed.all()


def test_commit_publishes_reach_the_cache():
    """A committed write of the cache's space bumps the written slots'
    versions (the flag word's slot) and the write tick; reads do not."""
    from repro_torch.core import cache as cache_mod
    c = cache_mod.BucketCache(P, L // 4, 2, capacity=64)
    eng = _engine(cache=c)
    t = Txn(P)
    t.put(np.arange(P), 8, 1)
    t.get(np.arange(P), 12)
    eng.run(_window(np.random.default_rng(62)), t, arm="rdma_fused")
    assert c.write_tick == 1
    assert (c.versions[:, 2] == 1).all() and c.versions.sum() == P


@pytest.mark.parametrize("seed", [3, 17, 29, 31])
def test_property_random_contention_serializable(seed):
    """Tiny universes, heavy conflicts, an arm per seed: serializable and
    conformant."""
    rng = np.random.default_rng(seed)
    for nops in (1, 3, 5):
        win = win_mod.Window(data=torch.as_tensor(
            rng.integers(-8, 8, size=(P, 8)).astype(np.int32)))
        init = {"ht": npy(win.data).copy()}
        t = Txn(P)
        for _ in range(nops):
            kind = int(rng.integers(0, 4))
            dst = rng.integers(0, P, P)
            off = rng.integers(0, 8, P)
            if kind == 0:
                t.put(dst, off, rng.integers(-8, 8, P))
            elif kind == 1:
                t.get(dst, off)
            elif kind == 2:
                t.cas(dst, off, rng.integers(-8, 8, P),
                      rng.integers(-8, 8, P), chain=rng.random() < 0.3)
            else:
                t.fao(dst, off, rng.integers(-3, 4, P))
        arm = txn_mod.TXN_ARMS[(seed + nops) % len(txn_mod.TXN_ARMS)]
        _assert_conformant(init, t, _engine().run(win, t, arm=arm))
