"""The adaptive chooser against the JAX package's: the same scripted stream
of decisions, injected latencies, quarantines, fault and transaction
counters, hysteresis, exploration, forced arms and the round-robin policy
goes to both packages' AdaptiveEngine, and every Decision must agree field
by field (scores to 1e-12), as must the engines' signals. Also the batch
statistics (batch_skew, batch_dedup, routing.owner_loads / plan_skew) on
random batches, the cache's seam, auto_depth's retargeting of a pipeline
and the fault plane's unserviced mask.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import am as jam
from repro.core import costmodel as jcm
from repro.core import routing as jrouting
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import adaptive as ad
from repro_torch.core import am, routing
from repro_torch.core import costmodel as cm
from repro_torch.core.types import OpStats, Promise
from torch_parity import same_decision, torch_one_thread, tt  # noqa: F401

P = 8


def _carry(params):
    return convert.component_costs(dataclasses.asdict(params))


def same_state(te, je):
    assert {(k[0].value, k[1]): v for k, v in te.ewma.items()} == \
        {(k[0].value, k[1]): v for k, v in je.ewma.items()}
    assert {(k[0].value, k[1]): v for k, v in te.depth_ewma.items()} == \
        {(k[0].value, k[1]): v for k, v in je.depth_ewma.items()}
    for f in ("health", "quarantined", "loss_ewma", "abort_ewma",
              "write_ewma", "hit_ewma", "_rr"):
        assert getattr(te, f) == getattr(je, f), f


class Plane:
    """A duck-typed fault plane: per-owner counters, taken once."""

    def __init__(self, stats):
        self.stats = stats

    def take_owner_stats(self):
        out, self.stats = self.stats, {}
        return out


class Pair:
    """The two packages' engines, driven with the same calls."""

    def __init__(self, params, **kw):
        self.j = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P),
                                    params=params, **kw)
        self.t = ad.AdaptiveEngine(P, am_engine=am.AMEngine(P),
                                   params=_carry(params), **kw)
        self.n = 0

    def decide(self, op, promise, dst=None, valid=None, stats=None, **kw):
        js = None if stats is None else jtypes.OpStats(**stats)
        ts = None if stats is None else OpStats(**stats)
        jd = self.j.decide(jcm.DSOp(op), jtypes.Promise(promise),
                           dst=dst, valid=valid, stats=js, **kw)
        td = self.t.decide(cm.DSOp(op), Promise(promise),
                           dst=None if dst is None else tt(dst),
                           valid=None if valid is None else tt(valid),
                           stats=ts, **kw)
        self.n += 1
        same_decision(td, jd, (self.n, op))
        return td, jd

    def observe(self, decs, us):
        td, jd = decs
        self.t.observe(td, us)
        self.j.observe(jd, us)

    def faults(self, stats):
        """Each engine ingests its own plane holding these counters."""
        self.t.ingest_fault_stats(Plane(dict(stats)))
        self.j.ingest_fault_stats(Plane(dict(stats)))

    def both(self, name, *a, **kw):
        getattr(self.t, name)(*a, **kw)
        getattr(self.j, name)(*a, **kw)


def _batch(rng, kind):
    if kind == "hot":
        return np.zeros((P, 16), np.int32)
    if kind == "skewed":
        return rng.choice(P, (P, 16), p=np.r_[0.5, [0.5 / (P - 1)] * (P - 1)]
                          ).astype(np.int32)
    return rng.integers(0, P, (P, 16)).astype(np.int32)


@pytest.mark.parametrize("params", [jcm.CORI_PHASE1, jcm.TPU_V5E_ICI],
                         ids=["cori", "tpu"])
def test_scripted_stream_matches_jax(params):
    rng = np.random.default_rng(3)
    e = Pair(params, explore_every=3, hysteresis=0.10)
    ins, fnd = "hash_insert", "hash_find"
    # the model alone: skew from dst, valid masks, dedup, busy owners
    for i, kind in enumerate(["uniform", "hot", "skewed", "uniform"]):
        valid = rng.random((P, 16)) > 0.2 if i % 2 else None
        e.decide(ins, "concurrent_read_write", _batch(rng, kind), valid,
                 dict(dedup=[1.0, 0.5][i % 2], target_busy_us=2.0 * i))
        e.decide(fnd, "concurrent_read", _batch(rng, kind),
                 stats=dict(expected_probes=1.5))
    # measured latencies take over arm by arm; then the EWMA fast path,
    # hysteresis (the incumbent holds within 10%), exploration of the
    # runner-up and the OBSERVE_CLIP of one spike
    lat = {"rdma": 5.0, "rdma_fused": 2.0, "am": 2.1, "am_pt": 3.0}
    for step in range(20):
        if step == 3:           # measure the two arms never chosen yet
            for arm in ("rdma", "am_pt"):
                e.t.force_arm = e.j.force_arm = arm
                e.observe(e.decide(ins, "concurrent_read_write",
                                   _batch(rng, "uniform")), lat[arm])
            e.t.force_arm = e.j.force_arm = None
        d = e.decide(ins, "concurrent_read_write", _batch(rng, "uniform"))
        us = lat[d[0].arm] * (1.0 + 0.03 * np.sin(step))
        if step == 6:
            us *= 40.0          # a spike, clipped at 4x the EWMA
        e.observe(d, us)
        if step == 10:
            lat["am"] = 1.9     # within the band: the incumbent stays
        if step == 14:
            lat["rdma_fused"] = 4.0
    for us in (1.0, 1.5):
        e.observe(e.decide(fnd, "concurrent_read", _batch(rng, "hot")), us)
    # owner health: quarantine, fault counters, straggler verdicts
    e.both("quarantine", 3, 0.7)
    e.both("quarantine", 5, 0.2)
    e.decide(fnd, "concurrent_read", np.full((P, 16), 3, np.int32))
    e.faults({0: {"rows": 100, "unserviced": 80, "retries": 10},
              1: {"rows": 50, "unserviced": 0, "retries": 20},
              3: {"rows": 40, "unserviced": 0, "retries": 0}})
    e.faults({3: {"rows": 40, "unserviced": 0, "retries": 0},
              2: {"rows": 10, "unserviced": 1, "retries": 2}})
    e.faults({})
    e.both("quarantine_from_monitor", {0: "ok", 1: "slow", 6: "dead",
                                       9: "replace"}, ranks_per_host=1)
    e.both("quarantine_from_monitor", {0: "fine", 1: "fine"},
           ranks_per_host=2)
    for kind in ("uniform", "hot"):
        e.decide("queue_push", "concurrent_read_write", _batch(rng, kind),
                 stats=dict(skew=float(P)), owners=(0,))
        e.decide("queue_pop", "concurrent_read", stats=dict(skew=2.0),
                 nops=P * 4, owners=(4,))
        e.decide(fnd, "concurrent_read", _batch(rng, kind))
    # transactions: the abort EWMA prices DSOp.TXN
    e.both("ingest_txn_stats", 0, 0)
    e.both("ingest_txn_stats", 30, 10)
    e.both("ingest_txn_stats", 10, 30)
    e.decide("txn", "concurrent_read_write", _batch(rng, "skewed"),
             stats=dict(ops_per_rank=4))
    # forced arms bypass the chooser and the quarantine re-route
    for arm in ("am", "rdma"):
        e.t.force_arm = e.j.force_arm = arm
        e.decide(fnd, "concurrent_read", np.full((P, 16), 6, np.int32))
        assert e.t.peek_arm(cm.DSOp.HT_FIND, Promise.CR) == arm
    e.t.force_arm = e.j.force_arm = None
    for op, pr in ((ins, "concurrent_read_write"), (fnd, "concurrent_read"),
                   ("queue_pop", "concurrent_read")):
        assert e.t.peek_arm(cm.DSOp(op), Promise(pr)) == e.j.peek_arm(
            jcm.DSOp(op), jtypes.Promise(pr))
    # pipeline depth: the model prior, then measured depths
    for depths in ({}, {2: 3.0}, {1: 1.0, 4: 9.0}):
        for d, us in depths.items():
            e.t.observe_depth(cm.DSOp.HT_INSERT, d, us)
            e.j.observe_depth(jcm.DSOp.HT_INSERT, d, us)
        for arm in (None, "am", "rdma_fused"):
            for mx in (None, 2):
                kw = dict(arm=arm, max_depth=mx)
                assert e.t.choose_depth(
                    cm.DSOp.HT_INSERT, Promise.CRW,
                    OpStats(skew=4.0, target_busy_us=3.0), **kw) == \
                    e.j.choose_depth(
                        jcm.DSOp.HT_INSERT, jtypes.Promise.CRW,
                        jtypes.OpStats(skew=4.0, target_busy_us=3.0), **kw)
    d = e.decide(ins, "concurrent_read_write", _batch(rng, "uniform"),
                 stats=dict(pipeline_depth=2))
    e.observe(d, 2.5)
    same_state(e.t, e.j)
    assert len(e.t.log) == len(e.j.log) == e.n
    sources = {d.source for d in e.t.log}
    assert {"model", "mixed", "ewma", "explore", "quarantine",
            "forced"} <= sources
    # the hysteresis band held an incumbent over a cheaper measured arm
    assert any(d.source == "ewma" and d.arm != min(
        d.scores, key=lambda a: (d.scores[a], e.t._ARM_RANK[a]))
        for d in e.t.log)


def test_round_robin_and_calibrate_match_jax():
    e = Pair(jcm.CORI_PHASE1, policy="round_robin")
    rng = np.random.default_rng(4)
    for i in range(9):
        op = ["hash_insert", "hash_find", "queue_push"][i % 3]
        pr = "concurrent_read_write" if i % 3 != 1 else "concurrent_read"
        e.decide(op, pr, _batch(rng, "uniform"))
    assert [d.arm for d in e.t.log] == list(cm.ARMS) * 2 + list(cm.ARMS[:1])
    cal = {"W": 1.5, "am_rt": 0.5, "A_cas_put": 2.0, "bogus": 1.0}
    assert dataclasses.asdict(e.t.calibrate(cal)) == dataclasses.asdict(
        e.j.calibrate(cal))
    e.both("quarantine", 1)
    same_state(e.t, e.j)
    # arms without an AM engine, and the argument checks
    assert ad.AdaptiveEngine(P).arms == jad.AdaptiveEngine(P).arms
    for kw in (dict(arms=("am",)), dict(arms=("nope",)),
               dict(policy="greedy")):
        with pytest.raises(ValueError):
            ad.AdaptiveEngine(P, **kw)


def test_batch_statistics_match_jax():
    rng = np.random.default_rng(5)
    n = 12      # one shape: one compile of the reference's plan
    for trial in range(12):
        dst = rng.integers(0, P, (P, n)).astype(np.int32)
        if trial % 4 == 1:
            dst[:] = trial % P
        keys = rng.integers(0, 6 if trial % 2 else 10 ** 6, (P, n)).astype(
            np.int32)
        valid = None if trial % 3 == 0 else rng.random((P, n)) > 0.4
        if trial == 5:
            valid = np.zeros((P, n), bool)
        tv = None if valid is None else tt(valid)
        assert ad.batch_skew(tt(dst), P, tv) == jad.batch_skew(dst, P, valid)
        assert ad.batch_dedup(tt(keys), tv) == jad.batch_dedup(keys, valid)
        assert ad.batch_skew(dst, P, valid) == jad.batch_skew(dst, P, valid)
        jplan = jrouting.make_plan(
            jnp.asarray(dst), None if valid is None else jnp.asarray(valid),
            cap=n)
        tplan = routing.make_plan(tt(dst), tv, cap=n)
        loads = routing.owner_loads(tplan)
        assert loads.dtype == torch.int32
        np.testing.assert_array_equal(
            loads.numpy(), np.asarray(jrouting.owner_loads(jplan)))
        sk = routing.plan_skew(tplan)
        assert sk.dtype == torch.float32 and sk.device == tplan.mask.device
        assert float(sk) == float(jrouting.plan_skew(jplan))


def test_seams_raise_naming_their_roadmap_items():
    # the cache seams (ROADMAP A10) run: the constructor and attach_cache
    # both attach the cache
    from repro_torch.core import cache
    c = cache.BucketCache(P, 64, 1, capacity=64)
    assert ad.AdaptiveEngine(P, cache=c).cache is c
    cached = ad.AdaptiveEngine(P)
    cached.attach_cache(c)
    assert cached.cache is c and cached.cache_reads_on()
    eng = ad.AdaptiveEngine(P)
    # auto_depth retargets a pipeline that opted in (capped at its
    # constructor depth) and passes a fixed-depth one through
    from repro_torch.core import faults, pipeline
    chooser = ad.AdaptiveEngine(P, am_engine=am.AMEngine(P))
    chooser.force_arm = "am"      # an owner-heavy arm: depth 2 hides it
    auto = pipeline.Pipeline(object(), depth=3, auto_depth=True)
    s = chooser.auto_depth(auto, cm.DSOp.HT_FIND, Promise.CR,
                           OpStats(target_busy_us=50.0))
    assert auto.depth == s.pipeline_depth == 2 == chooser.choose_depth(
        cm.DSOp.HT_FIND, Promise.CR, OpStats(target_busy_us=50.0),
        max_depth=3)
    fixed = pipeline.Pipeline(object(), depth=2)
    assert eng.auto_depth(fixed, cm.DSOp.HT_FIND, Promise.CR) == OpStats()
    assert fixed.depth == 2
    # _after_am returns the plane's unserviced mask (None without a plane)
    assert eng._after_am() is None
    plan = faults.FaultPlan(P, seed=1, dead_owners={3: None})
    dst = torch.arange(2 * P, dtype=torch.int32).reshape(2, P) % P
    with faults.fault_scope(plan):
        plan.inject_am(dst, None)
        uns = eng._after_am()
        np.testing.assert_array_equal(uns, dst.numpy() == 3)
        assert eng._after_am() is None        # taken once
    assert 3 in eng.quarantined
    assert not eng.cache_reads_on()
    # the default engines persist per nranks and per AM engine
    e = am.AMEngine(P)
    assert ad.default_engine(P) is ad.default_engine(P)
    assert ad.default_engine(P, am_engine=e) is ad.default_engine(
        P, am_engine=e)
    assert ad.default_engine(P, am_engine=e).arms == cm.ARMS
    assert ad.default_engine(P).params is cm.H100_SXM
