"""The fault plane of the port (`repro_torch.core.faults`) on the CPU: the
parts of tests/test_faults.py that need no cache, transaction or runtime
module, and the plane against the JAX package's.

  * the schedule is the JAX package's: the same hook calls with the same
    seed give the same keep masks, unserviced rows, owner counters and
    stats, bit for bit;
  * exactly-once conformance: under every seeded schedule each arm's
    results and final window equal its fault-free run, which equals the
    JAX package's; AUTO, the queue, the failovers and the pipelined
    stream run through both packages under the same plan, with equal
    results, windows, arms, quarantines and plan stats (the port's eager
    probe and CAS loops draw as JAX's traced ones, `faults.loop_scope`);
  * liveness: `Handle.result(timeout=)` on a dead queue raises the typed
    RemoteTimeout, a stalled one recovers; a pipeline left on an
    exception fails its stranded handles;
  * degradation: a dead owner is quarantined after one batch and its AM
    rows fail over to the one-sided lane, with the JAX package's result;
  * the cost model's retry terms.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import am as jam
from repro.core import cache as jcache
from repro.core import faults as jflt
from repro.core import hashtable as jht
from repro.core import pipeline as jpl
from repro.core import queue as jq
from repro.core import txn as jtxn
from repro.core import window as jwin
from repro.core.types import Promise as JPromise
from repro_torch.core import adaptive as ad_mod
from repro_torch.core import am as am_mod
from repro_torch.core import cache as cache_mod
from repro_torch.core import costmodel as cm
from repro_torch.core import faults as flt
from repro_torch.core import hashtable as ht_mod
from repro_torch.core import pipeline as pl_mod
from repro_torch.core import queue as q_mod
from repro_torch.core import txn as txn_mod
from repro_torch.core import window as win_mod
from repro_torch.core.costmodel import DSOp
from repro_torch.core.types import OpStats, Promise
from torch_parity import jit, npy, same, torch_one_thread  # noqa: F401

P = 4
VW = 2
NSLOTS = 128

j_insert = jit(jht.insert_rdma, "promise", "max_probes", "fused", "coalesce")
j_find = jit(jht.find_rdma, "promise", "max_probes", "fused", "coalesce")
j_insert_rpc = jit(jht.insert_rpc, "engine", "coalesce")
j_find_rpc = jit(jht.find_rpc, "engine", "coalesce")


def _val_of(keys):
    k = np.asarray(keys)
    return np.concatenate([((k * 31 + 7) & 0x7FFFFF)[..., None],
                           ((k * 17 + 3) & 0x7FFFFF)[..., None]],
                          axis=-1).astype(np.int32)


def _batches(seed, nbatches, n=8, lo=1, hi=4000):
    """Globally DISTINCT keys (the one-sided insert's domain; the AM
    handler is insert-or-assign), as tests/test_faults.py draws them."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(np.arange(lo, hi), size=nbatches * P * n,
                      replace=False)
    return [flat[i * P * n:(i + 1) * P * n].reshape(P, n).astype(np.int32)
            for i in range(nbatches)]


# the three seeded chaos schedules of tests/test_faults.py
def _schedules():
    return [
        ("drops", 1001, dict(seed=101, drop_rate=0.30)),
        ("dups", 2002, dict(seed=202, dup_rate=0.40)),
        ("mixed", 3003, dict(seed=303, drop_rate=0.15, dup_rate=0.15,
                             delay_rate=0.20, delay_rounds=2,
                             dead_owners={1: 3})),
    ]


# ---------------------------------------------------------------------------
# Determinism primitives
# ---------------------------------------------------------------------------
class TestRetryPolicy:
    def test_capped_exponential_backoff(self):
        rp = flt.RetryPolicy(max_attempts=8, base_delay=1.0, max_delay=16.0)
        jrp = jflt.RetryPolicy(max_attempts=8, base_delay=1.0,
                               max_delay=16.0)
        assert [rp.delay(a) for a in (1, 2, 4, 7)] == [1.0, 2.0, 8.0, 16.0]
        assert [rp.delay(a) for a in range(10)] == [jrp.delay(a)
                                                    for a in range(10)]

    def test_defaults(self):
        assert dataclasses.asdict(flt.RetryPolicy()) == dataclasses.asdict(
            jflt.RetryPolicy())
        assert issubclass(flt.RemoteTimeout, TimeoutError)


class TestDedupIndex:
    def test_seqs_contiguous_per_channel(self):
        d, jd = flt.DedupIndex(P), jflt.DedupIndex(P)
        dst = np.array([[1, 1, 2], [2, 2, 2], [0, 1, 2], [3, 3, 3]])
        active = np.ones_like(dst, bool)
        seqs = d.assign(dst, active)
        assert sorted(seqs[0, :2].tolist()) == [0, 1]
        assert sorted(seqs[1].tolist()) == [0, 1, 2]
        seqs2 = d.assign(dst, active)
        assert sorted(seqs2[1].tolist()) == [3, 4, 5]
        same(seqs, jd.assign(dst, active))
        same(seqs2, jd.assign(dst, active))

    def test_admit_filters_redelivery(self):
        d = flt.DedupIndex(P)
        assert d.admit(1, 0, 0) is True
        assert d.admit(1, 0, 0) is False   # duplicate delivery
        assert d.admit(1, 0, 1) is True
        assert d.dup_filtered == 1

    def test_watermark_advances_over_reordered_tags(self):
        d = flt.DedupIndex(P)
        assert d.admit(2, 0, 1) is True    # out of order
        assert d.admit(2, 0, 0) is True    # fills the gap
        assert d.watermark[2, 0] == 1
        assert not d.out_of_order.get((2, 0))
        assert d.admit(2, 0, 1) is False   # below the watermark now


class TestDeterminism:
    def _insert(self, **cfg):
        keys = torch.as_tensor(_batches(7, 1)[0])
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        plan = flt.FaultPlan(P, **cfg)
        with flt.fault_scope(plan):
            ht_mod.insert_rdma(ht, keys, torch.as_tensor(_val_of(keys)))
        return plan.stats()

    def test_same_seed_same_schedule(self):
        a = self._insert(seed=42, drop_rate=0.25, dup_rate=0.25)
        b = self._insert(seed=42, drop_rate=0.25, dup_rate=0.25)
        assert a == b and a["dropped"] > 0

    def test_different_seed_different_schedule(self):
        assert (self._insert(seed=1, drop_rate=0.25)["dropped"]
                != self._insert(seed=2, drop_rate=0.25)["dropped"])


# ---------------------------------------------------------------------------
# The plane's hooks against the JAX package's
# ---------------------------------------------------------------------------
def _plan_pair(cfg, exhaust=False):
    """The same FaultPlan in both packages (each with its own policy)."""
    extra = {}
    if exhaust:   # two attempts at drop 0.6: some rows are never applied
        extra = dict(retry=flt.RetryPolicy(max_attempts=2))
        jextra = dict(retry=jflt.RetryPolicy(max_attempts=2))
    else:
        jextra = {}
    return flt.FaultPlan(P, **cfg, **extra), jflt.FaultPlan(P, **cfg,
                                                             **jextra)


def _same_hook(got, jgot, valid, what):
    """A hook's result: `valid` itself when every row survived, else the
    folded keep mask."""
    if jgot is None or (valid is not None and jgot is valid[1]):
        assert got is valid[0] if valid is not None else got is None, what
    else:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
        same(got, jgot, what)


@pytest.mark.parametrize("name,cfg,exhaust", [
    (n, c, False) for n, _, c in _schedules()] + [
    ("exhaust", dict(seed=404, drop_rate=0.6, dead_owners={2: None}), True)])
def test_plan_hooks_match_jax(name, cfg, exhaust):
    """Both packages' plans through the same sequence of one-sided and AM
    hook calls, queue drains and ticks: equal keep masks, unserviced rows,
    owner counters, dedup state and stats after every call."""
    plan, jplan = _plan_pair(cfg, exhaust)
    rng = np.random.default_rng(len(name))
    for step in range(12):
        dst = rng.integers(0, P, (P, 6)).astype(np.int32)
        valid = None
        if step % 2:
            v = rng.random((P, 6)) < 0.7
            valid = (torch.as_tensor(v), jnp.asarray(v))
        tv, jv = (None, None) if valid is None else valid
        if step % 3 == 2:
            got = plan.inject_am(torch.as_tensor(dst), tv)
            jgot = jplan.inject_am(jnp.asarray(dst), jv)
            plan.tick()
            jplan.tick()
            u, ju = plan.take_unserviced(), jplan.take_unserviced()
            assert (u is None) == (ju is None), (name, step)
            if u is not None:
                same(u, ju, (name, step, "unserviced"))
        else:
            got = plan.inject_phase("get", torch.as_tensor(dst), tv)
            jgot = jplan.inject_phase("get", jnp.asarray(dst), jv)
        _same_hook(got, jgot, valid, (name, step))
        if step % 4 == 3:
            assert plan.take_owner_stats() == jplan.take_owner_stats()
            assert plan.wait_for_service() == jplan.wait_for_service()
        assert plan.stats() == jplan.stats(), (name, step)
        same(plan.dedup.watermark, jplan.dedup.watermark)
        assert plan.owner_stalled(1) == jplan.owner_stalled(1)
        assert plan.queue_stalled() == jplan.queue_stalled()
    if exhaust:
        assert plan.stats()["exhausted"] > 0


def _loop_case(name, jax):
    """One call of a loop of one-sided phases (probe rounds or CAS
    rounds) in one package: (the call, its structure's window)."""
    keys = _batches(21, 1)[0]
    vals = _val_of(keys)
    items = np.random.default_rng(21).integers(
        0, 99, size=(P, 4, VW)).astype(np.int32)
    if jax:
        ht, qm, pr, arr = jht, jq, JPromise, jnp.asarray
        table = jht.make_hashtable(P, NSLOTS, VW)
        queue = jq.make_queue(P, host=1, capacity=256, val_words=VW)
    else:
        ht, qm, pr, arr = ht_mod, q_mod, Promise, torch.as_tensor
        table = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        queue = q_mod.make_queue(P, host=1, capacity=256, val_words=VW,
                                 device="cpu")
    k, v, it = arr(keys), arr(vals), arr(items)
    half = arr(np.arange(keys.shape[1]) % 2 == 0)[None, :] & arr(
        np.ones(keys.shape, bool))
    if name.startswith("find"):    # half the keys present: hits and misses
        table, _, _ = ht.insert_rdma(table, k, v, valid=half)
    if name == "pop_crw":
        queue, _ = qm.push_rdma(queue, it)
    calls = {
        "insert_unfused": lambda: ht.insert_rdma(table, k, v, fused=False),
        "find_fused_crw": lambda: ht.find_rdma(table, k, promise=pr.CRW),
        "find_unfused_crw": lambda: ht.find_rdma(table, k, promise=pr.CRW,
                                                 fused=False),
        "pop_crw": lambda: qm.pop_rdma(queue, 4, promise=pr.CRW),
    }
    return calls[name]


@pytest.mark.parametrize("name", ["insert_unfused", "find_fused_crw",
                                  "find_unfused_crw", "pop_crw"])
def test_loop_draws_match_jax(name):
    """Loops of one-sided phases under a plan that exhausts rows (two
    attempts at drop 0.6), so that the drawn keep masks bite: the JAX
    package draws each phase of a traced loop body once and holds that
    mask in every round; the port's eager loop makes the same draws
    (`faults.loop_scope`), so the results, the window and the plan's
    state are equal bit for bit. The cases cover a loop followed by more
    phases, bodies of two and three phases, and a CAS-round loop; the
    chaos streams below run the other loops under the seeded schedules."""
    cfg = dict(seed=404, drop_rate=0.6, dup_rate=0.2)
    plan, jplan = _plan_pair(cfg, exhaust=True)
    call, jcall = _loop_case(name, jax=False), _loop_case(name, jax=True)
    with flt.fault_scope(plan):
        out = call()
    with jflt.fault_scope(jplan):
        jout = jcall()
    for a, b in zip(out[1:], jout[1:]):
        same(a, b, name)
    same(out[0].win.data, jout[0].win.data, (name, "window"))
    assert plan.stats() == jplan.stats(), name
    assert plan.stats()["exhausted"] > 0, name
    same(plan.dedup.watermark, jplan.dedup.watermark)


# ---------------------------------------------------------------------------
# Chaos conformance: every schedule x every arm == the fault-free run
# ---------------------------------------------------------------------------
class _ArmRunner:
    """A mixed insert/find stream on one arm through the chooser's
    wrappers (forced, or round robin for "auto"; "cached" is rdma_fused
    with a hot-bucket cache), optionally under a plan; the fault-free
    instance is the oracle. jax=True runs it in the JAX package, eagerly
    (its plane needs concrete batches)."""

    def __init__(self, arm, jax=False):
        if jax:
            self.ht = jht.make_hashtable(P, NSLOTS, VW)
            self.auto = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P),
                                           policy="round_robin")
            self.arr = jnp.asarray
            cache_cls = jcache.BucketCache
        else:
            self.ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
            self.auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P),
                                              policy="round_robin")
            self.arr = torch.as_tensor
            cache_cls = cache_mod.BucketCache
        if arm == "cached":
            self.auto.attach_cache(cache_cls(P, NSLOTS, VW, capacity=256,
                                             max_probes=8))
            arm = "rdma_fused"
        if arm != "auto":
            self.auto.policy = "cost"
            self.auto.force_arm = arm

    def insert(self, keys):
        self.ht, ok, _ = self.auto.ht_insert(self.ht, self.arr(keys),
                                             self.arr(_val_of(keys)))
        return npy(ok)

    def find(self, keys):
        self.ht, found, vals = self.auto.ht_find(self.ht, self.arr(keys))
        return npy(found), npy(vals)


def _same_engines(auto, jauto, plan, jplan, what):
    """The two packages' choosers and plans after the same stream: the arm
    of every Decision, owner health, quarantines and the plane's stats."""
    assert [d.arm for d in auto.log] == [d.arm for d in jauto.log], what
    assert auto.health == jauto.health, what
    assert auto.quarantined == jauto.quarantined, what
    assert plan.stats() == jplan.stats(), what


_JAX_REFS = {}


def _jax_reference(arm, batches, kseed):
    """The fault-free stream of a fixed arm in the JAX package (jitted):
    per batch (ok, found, vals), and the final window."""
    key = (arm, kseed)
    if key in _JAX_REFS:
        return _JAX_REFS[key]
    ht = jht.make_hashtable(P, NSLOTS, VW)
    eng = jam.AMEngine(P)
    jht.build_am_handlers(ht, eng)
    outs = []
    for keys in batches:
        k, v = jnp.asarray(keys), jnp.asarray(_val_of(keys))
        if arm == "am":
            ht, ok, _ = j_insert_rpc(ht, eng, k, v)
            found, vals = j_find_rpc(ht, eng, k)
        else:
            fused = arm == "rdma_fused"
            ht, ok, _ = j_insert(ht, k, v, fused=fused)
            ht, found, vals = j_find(ht, k, fused=fused)
        outs.append(tuple(np.asarray(x) for x in (ok, found, vals)))
    _JAX_REFS[key] = (outs, np.asarray(ht.win.data))
    return _JAX_REFS[key]


@pytest.mark.parametrize("arm", ["rdma", "rdma_fused", "am", "auto",
                                 "cached"])
@pytest.mark.parametrize("name,kseed,cfg", _schedules())
def test_chaos_conformance(arm, name, kseed, cfg):
    batches = _batches(seed=kseed, nbatches=4)
    oracle = _ArmRunner(arm)
    chaos = _ArmRunner(arm)
    plan = flt.FaultPlan(P, **cfg)
    live = arm in ("auto", "cached")
    ref = None if live else _jax_reference(arm, batches, kseed)
    if live:   # JAX's AUTO / cached engine under the same plan
        jchaos, jplan = _ArmRunner(arm, jax=True), jflt.FaultPlan(P, **cfg)
    for i, keys in enumerate(batches):
        ok_o = oracle.insert(keys)
        f_o, v_o = oracle.find(keys)
        with flt.fault_scope(plan):
            ok_c = chaos.insert(keys)
            f_c, v_c = chaos.find(keys)
        for a, b, what in ((ok_o, ok_c, "ok"), (f_o, f_c, "found"),
                           (v_o, v_c, "vals")):
            same(a, b, (arm, name, i, what))
        if ref is None:
            with jflt.fault_scope(jplan):
                ref_i = (jchaos.insert(keys),) + jchaos.find(keys)
        else:
            ref_i = ref[0][i]
        for a, b in zip((ok_c, f_c, v_c), ref_i):
            same(a, b, (arm, name, i, "jax"))
    if arm == "auto":
        same(chaos.ht.win.data, jchaos.ht.win.data, (arm, name, "jax"))
        _same_engines(chaos.auto, jchaos.auto, plan, jplan, (arm, name))
        # a quarantine re-route may run a batch on another (conformant)
        # arm than the fault-free run: every key reads back the same
        for keys in batches:
            f_o, v_o = oracle.find(keys)
            f_c, v_c = chaos.find(keys)
            same(f_o, f_c, (arm, name, "final-found"))
            same(v_o, v_c, (arm, name, "final-vals"))
    elif arm == "cached":
        # the first batch once more: served from the cache under the plan
        f_o, v_o = oracle.find(batches[0])
        with flt.fault_scope(plan):
            f_c, v_c = chaos.find(batches[0])
        with jflt.fault_scope(jplan):
            jf, jv = jchaos.find(batches[0])
        for a, b in ((f_o, f_c), (v_o, v_c), (f_c, jf), (v_c, jv)):
            same(a, b, (arm, name, "cached re-read"))
        same(oracle.ht.win.data, chaos.ht.win.data, (arm, name))
        same(chaos.ht.win.data, jchaos.ht.win.data, (arm, name, "jax"))
        _same_engines(chaos.auto, jchaos.auto, plan, jplan, (arm, name))
        stats = chaos.auto.cache.stats()
        assert stats == jchaos.auto.cache.stats(), (name, stats)
        assert stats == oracle.auto.cache.stats(), (name, stats)
        assert stats["hits"] > 0, stats
    else:
        same(oracle.ht.win.data, chaos.ht.win.data, (arm, name))
        same(chaos.ht.win.data, ref[1], (arm, name, "jax window"))
    s = plan.stats()
    assert s["dropped"] + s["dup_filtered"] + s["stall_hits"] > 0 \
        or plan.dead_owners, (name, s)


def test_chaos_duplicate_keys_visible_conformance():
    """Cross-origin duplicate keys under a dead owner: the AM oracle's
    insert-or-assign and the one-sided failover may differ in raw slot
    bits, but every visible read is identical; the failover equals the
    JAX package's under the same plan."""
    rng = np.random.default_rng(17)
    keys = rng.integers(1, 40, size=(P, 8)).astype(np.int32)   # dense
    oracle, chaos = _ArmRunner("am"), _ArmRunner("am")
    jchaos = _ArmRunner("am", jax=True)
    cfg = dict(seed=19, drop_rate=0.2, dup_rate=0.2, dead_owners={1: None})
    plan, jplan = flt.FaultPlan(P, **cfg), jflt.FaultPlan(P, **cfg)
    ok_o = oracle.insert(keys)
    f_o, v_o = oracle.find(keys)
    with flt.fault_scope(plan):
        ok_c = chaos.insert(keys)
        f_c, v_c = chaos.find(keys)
    with jflt.fault_scope(jplan):
        jout = (jchaos.insert(keys),) + jchaos.find(keys)
    same(ok_o, ok_c)
    same(f_o, f_c)
    same(v_o, v_c)
    assert 1 in chaos.auto.quarantined
    for a, b in zip((ok_c, f_c, v_c), jout):
        same(a, b, "jax")
    same(chaos.ht.win.data, jchaos.ht.win.data, "jax window")
    _same_engines(chaos.auto, jchaos.auto, plan, jplan, "dup keys")


def _queue_stream(vals, npop, arm, plan, jax=False):
    """Push + pop pairs on a queue hosted on rank 1 through the chooser
    (default policy, or forced to `arm`) under `plan`: (queue', per pair
    (ok, got, vals) as numpy, the engine)."""
    if jax:
        q = jq.make_queue(P, host=1, capacity=256, val_words=VW)
        auto = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P))
        scope, arr = jflt.fault_scope, jnp.asarray
    else:
        q = q_mod.make_queue(P, host=1, capacity=256, val_words=VW,
                             device="cpu")
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        scope, arr = flt.fault_scope, torch.as_tensor
    if arm != "auto":
        auto.force_arm = arm
    out = []
    with scope(plan):
        for v in vals:
            q, ok = auto.q_push(q, arr(v))
            q, got, pv = auto.q_pop(q, npop)
            out.append((npy(ok), npy(got), npy(pv)))
    return q, out, auto


def _same_queue_runs(a, b, what):
    for x, y in zip(a[1], b[1]):
        for u, v in zip(x, y):
            same(u, v, what)
    same(a[0].win.data, b[0].win.data, what)


@pytest.mark.parametrize("arm", ["rdma", "am", "auto"])
def test_chaos_conformance_queue(arm):
    rng = np.random.default_rng(9)
    vals = [rng.integers(0, 99, size=(P, 4, VW)).astype(np.int32)
            for _ in range(3)]
    cfg = dict(seed=77, drop_rate=0.25, dup_rate=0.25)
    oracle = _queue_stream(vals, 4, arm, None)
    plan, jplan = flt.FaultPlan(P, **cfg), jflt.FaultPlan(P, **cfg)
    chaos = _queue_stream(vals, 4, arm, plan)
    _same_queue_runs(oracle, chaos, arm)
    assert plan.stats()["dropped"] > 0
    jchaos = _queue_stream(vals, 4, arm, jplan, jax=True)
    _same_queue_runs(chaos, jchaos, (arm, "jax"))
    _same_engines(chaos[2], jchaos[2], plan, jplan, arm)


def test_queue_dead_host_fails_over():
    """The hosted queue's host is dead for its AM service: every AM push
    and pop row is unserviced and re-runs one-sided, equal to the
    one-sided arm's fault-free run and to the JAX package's failover."""
    rng = np.random.default_rng(10)
    vals = [rng.integers(0, 99, size=(P, 4, VW)).astype(np.int32)
            for _ in range(2)]
    cfg = dict(seed=5, dead_owners={1: None})
    oracle = _queue_stream(vals, 3, "rdma_fused", None)
    plan, jplan = flt.FaultPlan(P, **cfg), jflt.FaultPlan(P, **cfg)
    chaos = _queue_stream(vals, 3, "am", plan)
    _same_queue_runs(oracle, chaos, "dead host")
    assert chaos[2].quarantined == {1}
    assert plan.stats()["phases"] > 4    # the one-sided re-runs' phases
    jchaos = _queue_stream(vals, 3, "am", jplan, jax=True)
    _same_queue_runs(chaos, jchaos, "dead host jax")
    _same_engines(chaos[2], jchaos[2], plan, jplan, "dead host")


def _pipelined_chaos(batches, plan, jax=False):
    """Depth-2 insert stream, odd batches deferred, under `plan`: (table',
    per batch ok as numpy)."""
    if jax:
        ht, eng, mod = jht.make_hashtable(P, NSLOTS, VW), jam.AMEngine(P), jht
        scope, pipe_cls, arr = jflt.fault_scope, jpl.Pipeline, jnp.asarray
    else:
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        eng, mod = am_mod.AMEngine(P), ht_mod
        scope, pipe_cls = flt.fault_scope, pl_mod.Pipeline
        arr = torch.as_tensor

    def step(keys):
        k, v = arr(keys), arr(_val_of(keys))

        def op(st):
            st2, ok, pr = mod.insert_rdma(st, k, v)
            return st2, (ok, pr)
        return op

    outs = []
    with scope(plan):
        with pipe_cls(ht, depth=2, am_engine=eng) as pipe:
            hs = [pipe.submit(step(k), deferred=(i % 2 == 1), label=f"b{i}")
                  for i, k in enumerate(batches)]
            for h in hs:
                ok, _ = h.result(timeout=32)
                outs.append(npy(ok))
            return pipe.flush(), outs


def test_chaos_conformance_pipelined():
    """The pipelined engine under wire faults and a briefly stalled
    queue: deferred batches wait out the stall, results stay equal to
    the fault-free stream and to the JAX package's under the same plan."""
    batches = _batches(5, 4)
    cfg = dict(seed=11, drop_rate=0.2, dup_rate=0.2, stall_rounds=2)
    ht_o, outs_o = _pipelined_chaos(batches, None)
    plan, jplan = flt.FaultPlan(P, **cfg), jflt.FaultPlan(P, **cfg)
    ht_c, outs_c = _pipelined_chaos(batches, plan)
    for a, b in zip(outs_o, outs_c):
        same(a, b)
    same(ht_o.win.data, ht_c.win.data)
    assert plan.stall_hits > 0
    jht_c, jouts = _pipelined_chaos(batches, jplan, jax=True)
    for a, b in zip(outs_c, jouts):
        same(a, b, "jax")
    same(ht_c.win.data, jht_c.win.data, "jax window")
    assert plan.stats() == jplan.stats()


# ---------------------------------------------------------------------------
# Chaos conformance for transactions: every seeded schedule x every txn
# arm replays bit for bit as the fault-free run (aborts simply retry until
# exactly-once delivery wins through), and as the JAX engine under the
# same plan
# ---------------------------------------------------------------------------
def _txn_stream(plan, arm, win0, jax=False, batches=3, valid=None):
    """Contending txn batches (hot FAA word, per-rank CAS, a chain guard
    that may abort, cross-rank gets) on a fresh engine of either package:
    (final window, per batch (replies, committed, chain_ok), plan stats
    after each batch)."""
    if jax:
        tm, win = jtxn, jwin.Window(data=jnp.asarray(win0))
        eng, scope = jtxn.TxnEngine(P, am_engine=jam.AMEngine(P)), \
            jflt.fault_scope
    else:
        tm, win = txn_mod, win_mod.Window(data=torch.as_tensor(win0))
        eng, scope = txn_mod.TxnEngine(P, am_engine=am_mod.AMEngine(P)), \
            flt.fault_scope
    outs, stats = [], []
    with scope(plan):
        for i in range(batches):
            t = tm.Txn(P)
            t.fao(i % P, 0, np.arange(P) + i, valid=valid)     # hot word
            t.cas(np.arange(P), 2 + i, 0, 7, valid=valid)      # per rank
            t.cas((np.arange(P) + 2) % P, 8, -1, 5, chain=True,
                  valid=valid)                                 # may abort
            t.get((np.arange(P) + 1) % P, 5, valid=valid)
            r = eng.run(win, t, arm=arm)
            win = r.wins["ht"]
            outs.append((r.replies.copy(), r.committed.copy(),
                         r.chain_ok.copy()))
            stats.append(None if plan is None else plan.stats())
    return npy(win.data), outs, stats


def _same_txn_runs(a, b, what):
    same(a[0], b[0], (what, "window"))
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        for u, v in zip(x, y):
            same(u, v, (what, i))


@pytest.mark.parametrize("arm", ["rdma", "rdma_fused", "am", "am_pt"])
@pytest.mark.parametrize("name,kseed,cfg", _schedules())
def test_chaos_txn_conformance(arm, name, kseed, cfg):
    """Three batches under each schedule == fault-free; the first batch
    == the JAX engine's under the same plan (replies, flags, window and
    plan stats)."""
    rng = np.random.default_rng(kseed)
    win0 = rng.integers(-50, 50, size=(P, 16)).astype(np.int32)
    base = _txn_stream(None, arm, win0)
    plan = flt.FaultPlan(P, **cfg)
    faulty = _txn_stream(plan, arm, win0)
    _same_txn_runs(base, faulty, (arm, name))
    s = plan.stats()
    assert s["dropped"] + s["dup_filtered"] > 0 or plan.dead_owners, \
        (name, s)
    jplan = jflt.FaultPlan(P, **cfg)
    jfaulty = _txn_stream(jplan, arm, win0, jax=True, batches=1)
    one = _txn_stream(flt.FaultPlan(P, **cfg), arm, win0, batches=1)
    _same_txn_runs(one, jfaulty, (arm, name, "jax"))
    assert faulty[2][0] == one[2][0] == jplan.stats(), (arm, name)


def test_chaos_txn_dead_owner_times_out():
    """A permanently dead owner starves every AM lock/read row aimed at
    it: after `deadline` undelivered rounds the engine raises the typed
    RemoteTimeout, in both packages, after the same plan history."""
    rng = np.random.default_rng(71)
    data = rng.integers(-50, 50, size=(P, 16)).astype(np.int32)
    for jax in (False, True):
        f = jflt if jax else flt
        tm = jtxn if jax else txn_mod
        win = (jwin.Window(data=jnp.asarray(data)) if jax
               else win_mod.Window(data=torch.as_tensor(data)))
        eng = tm.TxnEngine(P, am_engine=(jam if jax else am_mod).AMEngine(P))
        plan = f.FaultPlan(P, seed=72, dead_owners={2: None},
                           retry=f.RetryPolicy(deadline=6))
        t = tm.Txn(P)
        t.put(2, 0, 5)                   # every rank writes the dead owner
        with f.fault_scope(plan):
            with pytest.raises(f.RemoteTimeout):
                eng.run(win, t, arm="am")
        if jax:
            assert plan.stats() == stats
        stats = plan.stats()


def test_chaos_txn_temporary_dead_owner_recovers():
    """An owner dead for 3 rounds, then revived: aborted rounds retry and
    the stream converges to the fault-free result, as the JAX engine's
    does under the same plan."""
    rng = np.random.default_rng(73)
    win0 = rng.integers(-50, 50, size=(P, 16)).astype(np.int32)
    base = _txn_stream(None, "am", win0)
    cfg = dict(seed=74, dead_owners={1: 3})
    faulty = _txn_stream(flt.FaultPlan(P, **cfg), "am", win0)
    _same_txn_runs(base, faulty, "dead 3")
    jplan = jflt.FaultPlan(P, **cfg)
    jfaulty = _txn_stream(jplan, "am", win0, jax=True, batches=1)
    one = _txn_stream(flt.FaultPlan(P, **cfg), "am", win0, batches=1)
    _same_txn_runs(one, jfaulty, "dead 3 jax")
    assert one[2][0] == jplan.stats()


def _pop_then_insert(plan, pv, jax=False, arm="rdma_fused", valid=None):
    if jax:
        q = jq.make_queue(P, host=1, capacity=32, val_words=VW)
        ht = jht.make_hashtable(P, nslots=64, val_words=VW)
        q, pushed = jq.push_rdma(q, jnp.asarray(pv))
        eng = jtxn.TxnEngine(P, am_engine=jam.AMEngine(P))
        qm, scope = jq, jflt.fault_scope
    else:
        q = q_mod.make_queue(P, host=1, capacity=32, val_words=VW,
                             device="cpu")
        ht = ht_mod.make_hashtable(P, nslots=64, val_words=VW, device="cpu")
        q, pushed = q_mod.push_rdma(q, pv)
        eng = txn_mod.TxnEngine(P, am_engine=am_mod.AMEngine(P))
        qm, scope = q_mod, flt.fault_scope
    assert npy(pushed).all()
    with scope(plan):
        q2, ht2, popped, vals = qm.pop_then_insert(q, ht, eng, arm=arm,
                                                   valid=valid)
    return npy(q2.win.data), npy(ht2.win.data), popped, vals


def test_chaos_pop_then_insert_conformant():
    """The cross-space composite under wire chaos: popped items, the final
    queue and the destination table equal the fault-free run (every rank,
    fused arm) and, on the am arm with two ranks contending, the JAX
    composite's under the same plan."""
    rng = np.random.default_rng(75)
    pv = rng.choice(3000, size=(P, 2, VW), replace=False).astype(np.int32)
    cfg = dict(seed=76, drop_rate=0.25, dup_rate=0.25)
    base = _pop_then_insert(None, pv)
    plan = flt.FaultPlan(P, **cfg)
    faulty = _pop_then_insert(plan, pv)
    for a, b in zip(base, faulty):
        same(a, b)
    assert plan.stats()["dropped"] > 0
    two = np.arange(P) % 2 == 0
    plan, jplan = flt.FaultPlan(P, **cfg), jflt.FaultPlan(P, **cfg)
    got = _pop_then_insert(plan, pv, arm="am", valid=two)
    want = _pop_then_insert(jplan, pv, jax=True, arm="am", valid=two)
    for a, b in zip(got, want):
        same(a, b, "jax")
    assert got[2].sum() == 2 and plan.stats() == jplan.stats()


# ---------------------------------------------------------------------------
# Bounded staleness: cached reads within `max_stale` bumps, in both
# packages
# ---------------------------------------------------------------------------
class TestBoundedStaleness:
    def _filled(self, seed, jax=False):
        keys = _batches(seed, 1, n=4)[0]
        if jax:
            c = jcache.BucketCache(P, NSLOTS, VW, capacity=256, max_probes=8)
            ht = jht.make_hashtable(P, NSLOTS, VW)
            k = jnp.asarray(keys)
            ht, _, _ = jht.insert_rdma(ht, k, jnp.asarray(_val_of(keys)))
            jht.find_rdma(ht, k, cache=c)                   # fill
        else:
            c = cache_mod.BucketCache(P, NSLOTS, VW, capacity=256,
                                      max_probes=8)
            ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
            ht, _, _ = ht_mod.insert_rdma(ht, keys, _val_of(keys))
            ht_mod.find_rdma(ht, keys, cache=c)             # fill
        return c, keys

    def test_max_stale_serves_lagging_entries(self):
        for jax in (False, True):
            c, keys = self._filled(12, jax)
            assert c.lookup(keys).all_hit
            # one invalidation round: overlapping probe windows may bump a
            # bucket several times, so tolerate the largest lag
            c.on_insert_keys(keys, None, 8)
            assert c.lookup(keys, max_stale=16).all_hit     # tolerated
            assert not c.lookup(keys, max_stale=0).hit.any()  # evicted
            if jax:
                assert c.stats() == stats
            stats = c.stats()

    def test_stale_past_tolerance_evicted(self):
        for jax in (False, True):
            c, keys = self._filled(13, jax)
            for _ in range(3):
                c.on_insert_keys(keys, None, 8)             # lag >= 3
            assert not c.lookup(keys, max_stale=1).hit.any()
            assert c.counters["stale_evicted"] > 0
            if jax:
                assert c.stats() == stats
            stats = c.stats()

    def test_ht_find_threads_max_stale(self):
        keys = _batches(14, 1, n=4)[0]
        outs = []
        for jax in (False, True):
            r = _ArmRunner("cached", jax=jax)
            r.insert(keys)
            f0, v0 = r.find(keys)                           # fills
            r.auto.cache.on_insert_keys(keys, None, 8)      # age entries
            r.ht, f1, v1 = r.auto.ht_find(r.ht, r.arr(keys), max_stale=1)
            same(f0, f1)
            same(v0, v1)
            outs.append((npy(f1), npy(v1), r.auto.cache.stats()))
        same(outs[0][0], outs[1][0])
        same(outs[0][1], outs[1][1])
        assert outs[0][2] == outs[1][2]


# ---------------------------------------------------------------------------
# Timeouts and liveness
# ---------------------------------------------------------------------------
def _insert_op():
    keys = torch.as_tensor(_batches(3, 1)[0])
    vals = torch.as_tensor(_val_of(keys))

    def op(st):
        st2, ok, pr = ht_mod.insert_rdma(st, keys, vals)
        return st2, (ok, pr)
    return op, keys, vals


class TestTimeout:
    def _pipe(self):
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        return pl_mod.Pipeline(ht, depth=4, am_engine=am_mod.AMEngine(P))

    def test_dead_owner_raises_remote_timeout(self):
        plan = flt.FaultPlan(P, seed=1, stall_forever=True)
        with flt.fault_scope(plan):
            pipe = self._pipe()
            h = pipe.submit(_insert_op()[0], deferred=True, label="ins")
            with pytest.raises(flt.RemoteTimeout):
                h.result(timeout=8)
            # sticky: the batch is guaranteed dropped
            with pytest.raises(flt.RemoteTimeout):
                h.result()
            assert h.done() and pipe.in_flight == 0

    def test_timeout_is_typed_timeout_error(self):
        assert issubclass(flt.RemoteTimeout, TimeoutError)

    def test_slow_owner_recovers_within_deadline(self):
        plan = flt.FaultPlan(P, seed=2, stall_rounds=3)
        with flt.fault_scope(plan):
            pipe = self._pipe()
            h = pipe.submit(_insert_op()[0], deferred=True, label="ins")
            ok, _ = h.result(timeout=16)
        assert plan.stall_hits == 3
        assert bool(ok.all())

    def test_deadline_default_from_retry_policy(self):
        plan = flt.FaultPlan(P, seed=3, stall_rounds=10,
                             retry=flt.RetryPolicy(deadline=4))
        with flt.fault_scope(plan):
            pipe = self._pipe()
            h = pipe.submit(_insert_op()[0], deferred=True)
            with pytest.raises(flt.RemoteTimeout, match="past 4 rounds"):
                h.result()     # no explicit timeout: the plan's deadline


class TestPipelineContextManager:
    def test_clean_exit_flushes(self):
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        eng = am_mod.AMEngine(P)
        op, keys, vals = _insert_op()
        with pl_mod.Pipeline(ht, depth=4, am_engine=eng) as pipe:
            h = pipe.submit(op, deferred=True)
        assert h.done()
        assert eng.pending_dispatches == 0
        ht1, _, _ = ht_mod.insert_rdma(ht, keys, vals)
        same(pipe.staged_state.win.data, ht1.win.data)

    def test_exception_path_fails_outstanding_handles(self):
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        eng = am_mod.AMEngine(P)
        plan = flt.FaultPlan(P, seed=5, stall_forever=True)
        with pytest.raises(RuntimeError, match="boom"):
            with flt.fault_scope(plan):
                with pl_mod.Pipeline(ht, depth=4, am_engine=eng) as pipe:
                    h = pipe.submit(_insert_op()[0], deferred=True)
                    raise RuntimeError("boom")
        # the stranded batch is failed, not silently lost...
        with pytest.raises(flt.RemoteTimeout):
            h.result()
        # ...and its queued thunk is a no-op for later users of the engine
        eng.drain_dispatch_queue()
        assert eng.pending_dispatches == 0
        assert pipe.staged_state is ht


# ---------------------------------------------------------------------------
# Graceful degradation: quarantine and failover
# ---------------------------------------------------------------------------
class TestQuarantine:
    def test_dead_owner_quarantined_after_one_batch_like_jax(self):
        keys = _batches(6, 1)[0]
        vals = _val_of(keys)
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        oracle, ok_o, _ = ad_mod.AdaptiveEngine(
            P, am_engine=am_mod.AMEngine(P)).ht_insert(
                ht, torch.as_tensor(keys), torch.as_tensor(vals))
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.force_arm = "am"
        plan = flt.FaultPlan(P, seed=8, dead_owners={2: None})
        with flt.fault_scope(plan):
            ht2, ok_c, pr_c = auto.ht_insert(ht, torch.as_tensor(keys),
                                             torch.as_tensor(vals))
        assert 2 in auto.quarantined and auto.health[2] == 1.0
        same(ok_o, ok_c)
        same(oracle.win.data, ht2.win.data)
        # the JAX package's chooser under the same plan: equal failover
        jauto = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P))
        jauto.force_arm = "am"
        jplan = jflt.FaultPlan(P, seed=8, dead_owners={2: None})
        with jflt.fault_scope(jplan):
            jht2, jok, jpr = jauto.ht_insert(
                jht.make_hashtable(P, NSLOTS, VW), jnp.asarray(keys),
                jnp.asarray(vals))
        same(ok_c, jok)
        same(pr_c, jpr)
        same(ht2.win.data, jht2.win.data)
        _same_engines(auto, jauto, plan, jplan, "insert failover")

    def test_dead_owner_finds_fail_over(self):
        keys = _batches(16, 1)[0]
        vals = _val_of(keys)
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        ht, ok, _ = ht_mod.insert_rdma(ht, torch.as_tensor(keys),
                                       torch.as_tensor(vals))
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.force_arm = "am"
        cfg = dict(seed=9, dead_owners={0: None, 3: None})
        plan = flt.FaultPlan(P, **cfg)
        with flt.fault_scope(plan):
            _, found, got = auto.ht_find(ht, torch.as_tensor(keys))
        assert bool(ok.all()) and bool(found.all())
        same(got, vals)
        assert auto.quarantined == {0, 3}
        # the JAX package's chooser under the same plan, on its own table
        jtab, jok, _ = j_insert(jht.make_hashtable(P, NSLOTS, VW),
                                jnp.asarray(keys), jnp.asarray(vals))
        same(ht.win.data, jtab.win.data)
        jauto = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P))
        jauto.force_arm = "am"
        jplan = jflt.FaultPlan(P, **cfg)
        with jflt.fault_scope(jplan):
            _, jfound, jgot = jauto.ht_find(jtab, jnp.asarray(keys))
        same(found, jfound)
        same(got, jgot)
        _same_engines(auto, jauto, plan, jplan, "find failover")

    def test_decision_reroutes_off_quarantined_owner(self):
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.quarantine(2)
        dst = torch.full((P, 8), 2, dtype=torch.int32)
        # AM far below every model price of the port's prior (H100_SXM)
        auto.ewma[(DSOp.HT_INSERT, "am")] = 1e-6
        auto.ewma[(DSOp.HT_INSERT, "am_pt")] = 2e-6
        dec = auto.decide(DSOp.HT_INSERT, Promise.CRW, dst=dst)
        assert dec.arm not in ("am", "am_pt")
        assert dec.source == "quarantine" and dec.quarantined

    def test_untargeted_batches_keep_am(self):
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.quarantine(2)
        auto.ewma[(DSOp.HT_INSERT, "am")] = 1e-6
        dst = torch.zeros((P, 8), dtype=torch.int32)
        dec = auto.decide(DSOp.HT_INSERT, Promise.CRW, dst=dst)
        assert not dec.quarantined and dec.arm == "am"

    def test_owner_hint_used_for_hosted_queue(self):
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.quarantine(1)
        auto.ewma[(DSOp.Q_PUSH, "am")] = 1e-6
        dec = auto.decide(DSOp.Q_PUSH, Promise.CRW, owners=(1,))
        assert dec.quarantined and dec.arm not in ("am", "am_pt")

    def test_release_hysteresis(self):
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P),
                                     alpha=0.5)
        auto.quarantine(3)
        assert 3 in auto.quarantined
        for _ in range(10):
            auto.quarantine_from_monitor({3: "healthy"})
        assert 3 not in auto.quarantined
        assert auto.health[3] < auto.QUARANTINE_ON / 2


# ---------------------------------------------------------------------------
# Cost model: retry/loss terms
# ---------------------------------------------------------------------------
class TestCostRetryTerms:
    def test_lossless_predictions_bit_identical(self):
        for op, pr in ((DSOp.HT_INSERT, Promise.CRW),
                       (DSOp.HT_FIND, Promise.CR),
                       (DSOp.Q_PUSH, Promise.CRW)):
            for arm in cm.ARMS:
                assert cm.predict_arm(op, pr, arm, OpStats()) == \
                    cm.predict_arm(op, pr, arm, OpStats(loss_rate=0.0))

    def test_loss_charges_am_more_than_rdma(self):
        s = OpStats(loss_rate=0.3)
        for op, pr in ((DSOp.HT_FIND, Promise.CR),
                       (DSOp.HT_INSERT, Promise.CRW)):
            d_am = (cm.predict_arm(op, pr, "am", s)
                    - cm.predict_arm(op, pr, "am", OpStats()))
            d_rd = (cm.predict_arm(op, pr, "rdma", s)
                    - cm.predict_arm(op, pr, "rdma", OpStats()))
            assert d_am > d_rd > 0.0, (op, d_am, d_rd)

    def test_trade_flips_toward_rdma_under_loss(self):
        params = cm.ComponentCosts(W=6.0, R=6.0, A_cas=6.0, A_fao=6.0,
                                   am_rt=5.0, handler=0.05,
                                   retry_penalty=1.0, name="flip")
        op, pr = DSOp.HT_FIND, Promise.CR
        lossless = {a: cm.predict_arm(op, pr, a, OpStats(), params)
                    for a in ("am", "rdma")}
        assert lossless["am"] < lossless["rdma"]
        lossy = {a: cm.predict_arm(op, pr, a, OpStats(loss_rate=0.6),
                                   params)
                 for a in ("am", "rdma")}
        assert lossy["rdma"] < lossy["am"]

    def test_calibrate_accepts_retry_penalty(self):
        assert cm.calibrate({"retry_penalty": 2.5}).retry_penalty == 2.5

    def test_loss_ewma_feeds_scores(self):
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        s0, _ = auto.scores(DSOp.HT_FIND, Promise.CR)
        auto.loss_ewma = 0.4
        s1, _ = auto.scores(DSOp.HT_FIND, Promise.CR)
        assert s1["am"] > s0["am"]
        s2, _ = auto.scores(DSOp.HT_FIND, Promise.CR,
                            OpStats(loss_rate=0.1))
        assert s2["am"] < s1["am"]

    def test_plane_pressure_feeds_loss_ewma(self):
        """Wire retries of a chaos batch raise the chooser's loss EWMA,
        which then prices every arm's retries."""
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.force_arm = "rdma_fused"
        keys = torch.as_tensor(_batches(8, 1)[0])
        plan = flt.FaultPlan(P, seed=12, drop_rate=0.4)
        with flt.fault_scope(plan):
            auto.ht_insert(ht_mod.make_hashtable(P, NSLOTS, VW,
                                                 device="cpu"),
                           keys, torch.as_tensor(_val_of(keys)))
        assert 0.0 < auto.loss_ewma < 1.0
