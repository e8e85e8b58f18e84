"""Differential conformance of the port (the hash-table and queue halves of
tests/test_conformance.py): the python oracle, `am`, `rdma`, `rdma_fused`
and the adaptive `auto` must give bit-identical visible results (ok and
found flags, values) for the same op sequences, on the CPU. Inserts use a
value derived from the key, so duplicate inserts are idempotent and the
RDMA insert-only and the RPC insert-or-assign agree on everything a reader
sees. Then the slice as a whole: one AUTO stream with policy "cost" and
measure=False through the JAX package's `hashtable.insert` / `find` and
through the port's takes the same arms and leaves the same window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import am as jam
from repro.core import costmodel as jcm
from repro.core import hashtable as jht
from repro.core import types as jtypes
from repro_torch.core import adaptive as ad
from repro_torch.core import am as am_mod
from repro_torch.core import costmodel as cm
from repro_torch.core import hashtable as ht_mod
from repro_torch.core import queue as q_mod
from repro_torch.core import routing
from repro_torch.core.types import Promise
from torch_parity import (AUTO_NSLOTS, AUTO_P, auto_stream, auto_val,
                          run_port_auto, same, torch_one_thread)  # noqa: F401

P = 4
VW = 1
HT_BACKENDS = ("am", "rdma", "rdma_fused", "auto")
Q_BACKENDS = ("am", "rdma", "rdma_fused", "auto")


def _val_of(keys):
    return ((np.asarray(keys) * 31 + 7) & 0x7FFFFF)[..., None]


def _np_val_of(key):
    return (key * 31 + 7) & 0x7FFFFF


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


class HtRunner:
    """One backend's table; `auto` cycles the arms (round_robin), so a
    multi-batch sequence crosses every arm boundary."""

    def __init__(self, backend, nslots=64, max_probes=8, coalesce=False):
        self.backend = backend
        self.max_probes = max_probes
        self.coalesce = coalesce
        self.ht = ht_mod.make_hashtable(P, nslots, VW, device="cpu")
        self.eng = am_mod.AMEngine(P)
        ht_mod.build_am_handlers(self.ht, self.eng, max_probes=max_probes)
        if backend == "auto":
            self.auto = ad.AdaptiveEngine(P, am_engine=self.eng,
                                          policy="round_robin")

    def insert(self, keys, valid=None):
        keys, valid = _t(keys), _t(valid)
        vals = _t(_val_of(keys))
        if self.backend == "am":
            self.ht, ok, _ = ht_mod.insert(
                self.ht, keys, vals, backend="rpc", engine=self.eng,
                valid=valid, coalesce=self.coalesce)
        elif self.backend == "auto":
            self.ht, ok, _ = ht_mod.insert(
                self.ht, keys, vals, promise=Promise.CRW, engine=self.eng,
                adaptive=self.auto, valid=valid, max_probes=self.max_probes)
        else:
            self.ht, ok, _ = ht_mod.insert(
                self.ht, keys, vals, promise=Promise.CRW, backend="rdma",
                valid=valid, max_probes=self.max_probes,
                fused=self.backend == "rdma_fused", coalesce=self.coalesce)
        return ok.numpy()

    def find(self, keys, promise=Promise.CR, valid=None):
        keys, valid = _t(keys), _t(valid)
        if self.backend == "am":
            _, found, vals = ht_mod.find(self.ht, keys, backend="rpc",
                                         engine=self.eng, valid=valid,
                                         coalesce=self.coalesce)
        elif self.backend == "auto":
            self.ht, found, vals = ht_mod.find(
                self.ht, keys, promise=promise, engine=self.eng,
                adaptive=self.auto, valid=valid, max_probes=self.max_probes)
        else:
            self.ht, found, vals = ht_mod.find(
                self.ht, keys, promise=promise, backend="rdma", valid=valid,
                max_probes=self.max_probes,
                fused=self.backend == "rdma_fused", coalesce=self.coalesce)
        return found.numpy(), vals.numpy()


class HtOracle:
    """A dict applied in the engine's (src_rank, slot) order; valid while
    the table has headroom."""

    def __init__(self):
        self.d = {}

    def insert(self, keys, valid=None):
        k = np.asarray(keys)
        v = np.ones(k.shape, bool) if valid is None else np.asarray(valid)
        for key, ok in zip(k.ravel().tolist(), v.ravel().tolist()):
            if ok:
                self.d[key] = _np_val_of(key)
        return v

    def find(self, keys, valid=None):
        k = np.asarray(keys)
        v = np.ones(k.shape, bool) if valid is None else np.asarray(valid)
        found = np.zeros(k.shape, bool)
        vals = np.zeros(k.shape + (VW,), np.int32)
        for idx in np.ndindex(k.shape):
            if v[idx] and int(k[idx]) in self.d:
                found[idx] = True
                vals[idx] = self.d[int(k[idx])]
        return found, vals


def _distinct_keys(rng, shape, used=None):
    used = set() if used is None else used
    out = np.empty(int(np.prod(shape)), np.int64)
    i = 0
    while i < out.size:
        k = int(rng.integers(1, 1 << 30))
        if k not in used:
            used.add(k)
            out[i] = k
            i += 1
    return out.reshape(shape).astype(np.int32)


def _assert_all_agree(results, label):
    names = list(results)
    ref = results[names[0]]
    for name in names[1:]:
        np.testing.assert_array_equal(
            ref, results[name], err_msg=f"{label}: {names[0]} != {name}")


def _agree_finds(founds, label):
    _assert_all_agree({b: f[0] for b, f in founds.items()}, label + " found")
    _assert_all_agree({b: f[1] for b, f in founds.items()}, label + " vals")


# ---------------------------------------------------------------------------
# Hash table
# ---------------------------------------------------------------------------
def test_ht_random_sequences_all_backends_agree():
    rng = np.random.default_rng(0)
    runners = {b: HtRunner(b, nslots=128) for b in HT_BACKENDS}
    oracle = HtOracle()
    used: set = set()
    inserted = []
    for step in range(4):
        keys = _distinct_keys(rng, (P, 6), used)
        inserted.append(keys)
        oks = {b: r.insert(keys) for b, r in runners.items()}
        oks["oracle"] = oracle.insert(keys)
        _assert_all_agree(oks, f"insert ok step {step}")
        probe = np.concatenate(
            [inserted[rng.integers(0, len(inserted))][:, :3],
             _distinct_keys(rng, (P, 3), used)], axis=1)
        founds = {b: r.find(probe) for b, r in runners.items()}
        founds["oracle"] = oracle.find(probe)
        _agree_finds(founds, f"step {step}")


def test_ht_duplicate_keys_within_batch_agree():
    rng = np.random.default_rng(1)
    runners = {b: HtRunner(b, nslots=128) for b in HT_BACKENDS}
    oracle = HtOracle()
    base = _distinct_keys(rng, (P, 3))
    dup = np.concatenate([base, base[:, :2], np.roll(base[:, :1], 1, 0)],
                         axis=1)
    oks = {b: r.insert(dup) for b, r in runners.items()}
    oks["oracle"] = oracle.insert(dup)
    _assert_all_agree(oks, "duplicate insert ok")
    founds = {b: r.find(base) for b, r in runners.items()}
    founds["oracle"] = oracle.find(base)
    _agree_finds(founds, "dup")


def test_ht_duplicate_keys_across_batches_agree():
    rng = np.random.default_rng(2)
    runners = {b: HtRunner(b, nslots=128) for b in HT_BACKENDS}
    keys = _distinct_keys(rng, (P, 4))
    for _ in range(3):
        oks = {b: r.insert(keys) for b, r in runners.items()}
        _assert_all_agree(oks, "re-insert ok")
    _agree_finds({b: r.find(keys) for b, r in runners.items()}, "re")


def _keys_per_owner(rng, per_owner, used):
    """(P, per_owner) distinct keys, row p all owned by rank p."""
    out = [[] for _ in range(P)]
    while any(len(row) < per_owner for row in out):
        k = int(rng.integers(1, 1 << 30))
        owner = int(ht_mod.place_np(P, 1, np.array([k]))[0][0])
        if k not in used and len(out[owner]) < per_owner:
            used.add(k)
            out[owner].append(k)
    return np.asarray(out, np.int32)


def test_ht_full_table_fill_and_overflow_agree():
    """Fill a tiny table exactly (max_probes == nslots), then overflow it:
    every backend fails every further insert, and every fill key stays
    findable with identical values."""
    rng = np.random.default_rng(3)
    nslots = 4
    runners = {b: HtRunner(b, nslots=nslots, max_probes=nslots)
               for b in HT_BACKENDS}
    used: set = set()
    fill = _keys_per_owner(rng, nslots, used)
    oks = {b: r.insert(fill) for b, r in runners.items()}
    _assert_all_agree(oks, "fill insert ok")
    assert next(iter(oks.values())).all()
    over = _distinct_keys(rng, (P, 3), used)
    oks = {b: r.insert(over) for b, r in runners.items()}
    _assert_all_agree(oks, "overflow insert ok")
    assert not next(iter(oks.values())).any()
    probe = np.concatenate([fill, over], axis=1)
    founds = {b: r.find(probe) for b, r in runners.items()}
    _agree_finds(founds, "overflow")
    ref = next(iter(founds.values()))[0]
    np.testing.assert_array_equal(ref[:, :nslots], True)
    np.testing.assert_array_equal(ref[:, nslots:], False)


def test_ht_missing_keys_and_valid_mask_agree():
    rng = np.random.default_rng(4)
    runners = {b: HtRunner(b, nslots=64) for b in HT_BACKENDS}
    used: set = set()
    keys = _distinct_keys(rng, (P, 5), used)
    valid = rng.integers(0, 2, (P, 5)).astype(bool)
    for r in runners.values():
        r.insert(keys, valid=valid)
    probe = np.concatenate([keys, _distinct_keys(rng, (P, 3), used)], axis=1)
    founds = {b: r.find(probe) for b, r in runners.items()}
    _agree_finds(founds, "masked")
    np.testing.assert_array_equal(next(iter(founds.values()))[0][:, :5],
                                  valid)


def test_ht_crw_locked_find_agrees_with_cr():
    rng = np.random.default_rng(5)
    runners = {b: HtRunner(b, nslots=64)
               for b in ("rdma", "rdma_fused", "auto")}
    oracle = HtOracle()
    keys = _distinct_keys(rng, (P, 6))
    for r in runners.values():
        r.insert(keys)
    oracle.insert(keys)
    founds = {b: r.find(keys, promise=Promise.CRW)
              for b, r in runners.items()}
    founds["oracle"] = oracle.find(keys)
    _agree_finds(founds, "crw")


def _zipf_dup_keys(rng, n_universe, shape, alpha=1.2):
    universe = rng.choice(np.arange(1, 1 << 20), size=n_universe,
                          replace=False)
    probs = 1.0 / np.arange(1, n_universe + 1) ** alpha
    probs /= probs.sum()
    return rng.choice(universe, size=shape, p=probs).astype(np.int32)


def test_ht_zipfian_duplicate_stream_all_arms_coalesced_agree():
    """Duplicate-heavy streams: identical across {am, rdma, rdma_fused,
    auto} x {coalesce on, off} and the oracle (auto coalesces by itself
    when dedup < 1)."""
    rng = np.random.default_rng(20)
    runners = {}
    for b in HT_BACKENDS:
        runners[b] = HtRunner(b, nslots=256, max_probes=64)
        if b != "auto":
            runners[b + "+co"] = HtRunner(b, nslots=256, max_probes=64,
                                          coalesce=True)
    oracle = HtOracle()
    for step in range(3):
        keys = _zipf_dup_keys(rng, 12, (P, 8))
        oks = {b: r.insert(keys) for b, r in runners.items()}
        oks["oracle"] = oracle.insert(keys)
        _assert_all_agree(oks, f"zipf insert ok step {step}")
        probe = _zipf_dup_keys(rng, 12, (P, 8))
        founds = {b: r.find(probe) for b, r in runners.items()}
        founds["oracle"] = oracle.find(probe)
        _agree_finds(founds, f"zipf step {step}")


def test_ht_dup_key_find_coalesced_single_probe():
    """One hot key everywhere ships ONE request row per origin and every
    duplicate gets its record."""
    rng = np.random.default_rng(21)
    runners = {b: HtRunner(b, nslots=128, max_probes=16)
               for b in HT_BACKENDS}
    runners.update({b + "+co": HtRunner(b, nslots=128, max_probes=16,
                                        coalesce=True)
                    for b in HT_BACKENDS if b != "auto"})
    base = _distinct_keys(rng, (P, 4))
    for r in runners.values():
        r.insert(base)
    hot = np.broadcast_to(base[:1, :1], (P, 8)).astype(np.int32)
    founds = {b: r.find(hot) for b, r in runners.items()}
    _agree_finds(founds, "hot")
    assert next(iter(founds.values()))[0].all()
    co = routing.coalesce(torch.zeros((P, 8), dtype=torch.int32),
                          torch.zeros((P, 8), dtype=torch.int32),
                          match=torch.as_tensor(hot)[..., None])
    np.testing.assert_array_equal(co.rows_out.numpy(), np.ones(P))


# ---------------------------------------------------------------------------
# Queue
# ---------------------------------------------------------------------------
class QRunner:
    def __init__(self, backend, capacity=64):
        self.backend = backend
        self.q = q_mod.make_queue(P, host=1, capacity=capacity, val_words=VW,
                                  device="cpu")
        self.eng = am_mod.AMEngine(P)
        q_mod.build_am_handlers(self.q, self.eng)
        if backend == "auto":
            self.auto = ad.AdaptiveEngine(P, am_engine=self.eng,
                                          policy="round_robin")

    def push(self, vals, valid=None):
        vals, valid = _t(vals), _t(valid)
        if self.backend == "am":
            self.q, ok = q_mod.push(self.q, vals, backend="rpc",
                                    engine=self.eng, valid=valid)
        elif self.backend == "auto":
            self.q, ok = q_mod.push(self.q, vals, promise=Promise.CRW,
                                    engine=self.eng, adaptive=self.auto,
                                    valid=valid)
        else:
            self.q, ok = q_mod.push(self.q, vals, promise=Promise.CRW,
                                    backend="rdma", valid=valid,
                                    planned=self.backend == "rdma_fused")
        return ok.numpy()

    def pop(self, n):
        if self.backend == "am":
            self.q, got, vals = q_mod.pop(self.q, n, backend="rpc",
                                          engine=self.eng)
        elif self.backend == "auto":
            self.q, got, vals = q_mod.pop(self.q, n, promise=Promise.CRW,
                                          engine=self.eng, adaptive=self.auto)
        else:
            self.q, got, vals = q_mod.pop(
                self.q, n, promise=Promise.CRW, backend="rdma",
                planned=self.backend == "rdma_fused")
        return got.numpy(), vals.numpy()


class QOracle:
    """Bounded FIFO fed in the engine's (src_rank, slot) order."""

    def __init__(self, capacity):
        self.fifo: list = []
        self.capacity = capacity

    def push(self, vals, valid=None):
        v = np.asarray(vals)
        ok_in = (np.ones(v.shape[:2], bool) if valid is None
                 else np.asarray(valid))
        ok = np.zeros(v.shape[:2], bool)
        for p in range(v.shape[0]):
            for i in range(v.shape[1]):
                if ok_in[p, i] and len(self.fifo) < self.capacity:
                    self.fifo.append(v[p, i].copy())
                    ok[p, i] = True
        return ok

    def pop(self, n):
        got = np.zeros((P, n), bool)
        vals = np.zeros((P, n, VW), np.int32)
        for p in range(P):
            for i in range(n):
                if self.fifo:
                    vals[p, i] = self.fifo.pop(0)
                    got[p, i] = True
        return got, vals


def _batch_vals(rng, n):
    return rng.integers(1, 1 << 20, (P, n, VW)).astype(np.int32)


def test_queue_push_pop_sequences_agree():
    rng = np.random.default_rng(10)
    runners = {b: QRunner(b, capacity=512) for b in Q_BACKENDS}
    oracle = QOracle(512)
    for step in range(4):
        vals = _batch_vals(rng, 5)
        oks = {b: r.push(vals) for b, r in runners.items()}
        oks["oracle"] = oracle.push(vals)
        _assert_all_agree(oks, f"push ok step {step}")
        pops = {b: r.pop(3) for b, r in runners.items()}
        pops["oracle"] = oracle.pop(3)
        _agree_finds(pops, f"pop step {step}")


def test_queue_empty_pop_agree():
    runners = {b: QRunner(b) for b in Q_BACKENDS}
    for b, r in runners.items():
        got, vals = r.pop(4)
        assert not got.any() and (vals == 0).all(), b
    vals = _batch_vals(np.random.default_rng(11), 1)
    for r in runners.values():
        r.push(vals)
    _agree_finds({b: r.pop(8) for b, r in runners.items()}, "drain")
    for b, r in runners.items():
        assert not r.pop(2)[0].any(), b


def test_queue_full_ring_overflow_agree():
    rng = np.random.default_rng(12)
    cap = 8
    runners = {b: QRunner(b, capacity=cap) for b in Q_BACKENDS}
    oracle = QOracle(cap)
    vals = _batch_vals(rng, 4)
    oks = {b: r.push(vals) for b, r in runners.items()}
    oks["oracle"] = oracle.push(vals)
    _assert_all_agree(oks, "overflow push ok")
    assert int(next(iter(oks.values())).sum()) == cap
    pops = {b: r.pop(4) for b, r in runners.items()}
    pops["oracle"] = oracle.pop(4)
    _agree_finds(pops, "overflow")


# ---------------------------------------------------------------------------
# Adaptive-specific conformance
# ---------------------------------------------------------------------------
def test_auto_arm_switches_mid_sequence_are_invisible():
    rng = np.random.default_rng(13)
    r = HtRunner("auto", nslots=128)
    used: set = set()
    for _ in range(4):
        keys = _distinct_keys(rng, (P, 4), used)
        r.insert(keys)
        r.find(keys)
    assert {d.arm for d in r.auto.log} == set(cm.ARMS)
    assert all(d.batch_ops == P * 4 for d in r.auto.log)


def test_auto_cost_policy_conformant_and_logged():
    """The cost policy with measure=True: results equal the rdma_fused
    reference, every batch logged a Decision with scores for all arms, and
    the measured EWMAs were fed back."""
    rng = np.random.default_rng(14)
    auto = HtRunner("auto", nslots=128)
    auto.auto = ad.AdaptiveEngine(P, am_engine=auto.eng, policy="cost",
                                  measure=True)
    ref = HtRunner("rdma_fused", nslots=128)
    used: set = set()
    for _ in range(3):
        keys = _distinct_keys(rng, (P, 4), used)
        np.testing.assert_array_equal(auto.insert(keys), ref.insert(keys))
        fa, fr = auto.find(keys), ref.find(keys)
        np.testing.assert_array_equal(fa[0], fr[0])
        np.testing.assert_array_equal(fa[1], fr[1])
    assert len(auto.auto.log) == 6
    for dec in auto.auto.log:
        assert dec.arm in cm.ARMS and set(dec.scores) == set(cm.ARMS)
        assert dec.skew >= 1.0
    assert auto.auto.ewma


def test_skew_statistic_matches_route_plan():
    rng = np.random.default_rng(15)
    for _ in range(4):
        dst = torch.as_tensor(rng.integers(0, P, (P, 9)), dtype=torch.int32)
        plan = routing.make_plan(dst, cap=9)
        np.testing.assert_allclose(ad.batch_skew(dst, P),
                                   float(routing.plan_skew(plan)), rtol=1e-6)
    hot = torch.zeros((P, 9), dtype=torch.int32)
    assert ad.batch_skew(hot, P) == pytest.approx(P)
    assert float(routing.plan_skew(routing.make_plan(hot, cap=9))) == \
        pytest.approx(P)


def test_default_backend_is_auto():
    """No backend argument: the front doors run the cached default engine
    (the one-sided arms without an AM engine, all four with one)."""
    rng = np.random.default_rng(16)
    keys = _distinct_keys(rng, (P, 4))
    t = ht_mod.make_hashtable(P, 64, VW, device="cpu")
    t, ok, _ = ht_mod.insert(t, _t(keys), _t(_val_of(keys)))
    _, found, vals = ht_mod.find(t, _t(keys))
    assert ok.all() and found.all()
    same(vals, _val_of(keys))
    dec = ad.default_engine(P).last_decision
    assert dec.arm in ("rdma", "rdma_fused") and dec.source == "model"
    eng = am_mod.AMEngine(P)
    q = q_mod.make_queue(P, host=0, capacity=16, val_words=VW, device="cpu")
    q, ok = q_mod.push(q, _t(keys[..., None]), engine=eng)
    q, got, vals = q_mod.pop(q, 4, engine=eng)
    assert ok.all() and got.all()
    assert ad.default_engine(P, am_engine=eng).log[-1].op == cm.DSOp.Q_POP


# ---------------------------------------------------------------------------
# The slice as a whole: the same AUTO stream in both packages
# ---------------------------------------------------------------------------
def _run_jax_auto(params):
    table = jht.make_hashtable(AUTO_P, AUTO_NSLOTS, 1)
    engine = jam.AMEngine(AUTO_P)
    chooser = jad.AdaptiveEngine(AUTO_P, am_engine=engine, params=params,
                                 explore_every=3)
    arms, results = [], []
    for keys, fkeys, busy in auto_stream():
        stats = jtypes.OpStats(target_busy_us=busy)
        table, ok, probes = jht.insert(
            table, jnp.asarray(keys), jnp.asarray(auto_val(keys)),
            promise=jtypes.Promise.CRW, engine=engine, adaptive=chooser,
            stats=stats)
        arms.append(chooser.last_decision.arm)
        table, found, vals = jht.find(
            table, jnp.asarray(fkeys), promise=jtypes.Promise.CR,
            engine=engine, adaptive=chooser, stats=stats)
        arms.append(chooser.last_decision.arm)
        results += [np.asarray(x) for x in (ok, probes, found, vals)]
    return arms, results, np.asarray(table.win.data)


@pytest.fixture(scope="module")
def jax_cache_cleared_after():
    """The two streams share the reference's compiled functions; the
    caches are dropped once both have run (the reference's memory)."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["h100", "cori"])
def test_auto_stream_matches_jax(name, jax_cache_cleared_after):
    """policy "cost", measure=False, explore_every=3, owner busy times
    that flip the AM arms: the same arms, results and final window, bit
    for bit, with the port's parameters carried to the JAX package."""
    params = {"h100": cm.H100_SXM, "cori": cm.CORI_PHASE1}[name]
    arms, res, data = run_port_auto("cpu", params)
    j_arms, j_res, j_data = _run_jax_auto(
        jcm.ComponentCosts(**dataclasses.asdict(params)))
    assert arms == j_arms
    assert len(set(arms)) >= 2
    for i, (x, y) in enumerate(zip(res, j_res)):
        same(x, y, f"result {i}")
    same(data, j_data, "final window")
