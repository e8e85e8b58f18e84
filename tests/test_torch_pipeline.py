"""The pipelined engine of the port (`repro_torch.core.pipeline` and the
`*_async` front doors) against its synchronous front doors and the JAX
package, on the CPU: the contracts of tests/test_pipeline.py.

  * submission order IS serialization order: async == sync == JAX, values
    and final window, at depths 1, 2 and 3, with out-of-order forcing;
  * deferred (AM-arm) batches wait for a dispatch point and drain FIFO;
  * AUTO through the pipeline makes the JAX package's Decisions (skew
    and dedup counted on the host, the depth priced in);
  * the slot-tagged phase log and the exchange roles are JAX's, and
    pipelining adds no exchange;
  * auto_depth retargets the window count, and set_depth clamps and
    forces.

The JAX side runs jitted where the values are compared (its functions are
tracer-safe; one compile per shape), and eagerly where it logs at trace
time.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import am as jam
from repro.core import costmodel as jcm
from repro.core import hashtable as jht
from repro.core import pipeline as jpl
from repro.core import queue as jq
from repro.core import window as jwin
from repro.core.types import OpStats as JOpStats
from repro.core.types import Promise as JPromise
from repro_torch import convert
from repro_torch.core import adaptive as ad
from repro_torch.core import am as am_mod
from repro_torch.core import costmodel as cm
from repro_torch.core import hashtable as ht_mod
from repro_torch.core import pipeline as pl_mod
from repro_torch.core import queue as q_mod
from repro_torch.core import routing, window
from repro_torch.core.types import OpStats, Promise
from torch_parity import jit, same, same_decision, torch_one_thread  # noqa

P = 4
VW = 2
NSLOTS = 64

j_insert = jit(jht.insert_rdma, "promise", "max_probes", "fused", "coalesce")
j_find = jit(jht.find_rdma, "promise", "max_probes", "fused", "coalesce")
j_insert_rpc = jit(jht.insert_rpc, "engine", "coalesce")
j_find_rpc = jit(jht.find_rpc, "engine", "coalesce")
j_push = jit(jq.push_rdma, "promise", "max_cas_rounds", "planned",
             "coalesce")
j_pop = jit(jq.pop_rdma, "n", "promise", "max_cas_rounds", "planned",
            "coalesce")


def _batch(rng, n=8, dup=False):
    if dup:
        universe = rng.integers(1, 1 << 20, 6).astype(np.int32)
        keys = rng.choice(universe, size=(P, n)).astype(np.int32)
    else:
        keys = rng.integers(1, (1 << 31) - 2, (P, n)).astype(np.int32)
    vals = (keys[..., None] * np.arange(1, VW + 1)).astype(np.int32)
    return keys, vals


def _port_replay(ht, ops, engine=None):
    """The op stream through the port's synchronous front doors."""
    outs = []
    for kind, args, kw in ops:
        args = tuple(torch.as_tensor(a) for a in args)
        if kind == "insert":
            ht, ok, probes = ht_mod.insert(ht, *args, engine=engine, **kw)
            outs.append((ok, probes))
        else:
            ht, found, vals = ht_mod.find(ht, *args, engine=engine, **kw)
            outs.append((found, vals))
    return ht, outs


def _jax_replay(ops, engine=None):
    """The op stream through the JAX package, jitted, in order."""
    ht = jht.make_hashtable(P, NSLOTS, VW)
    if engine is not None:
        jht.build_am_handlers(ht, engine)
    outs = []
    for kind, args, kw in ops:
        args = tuple(jnp.asarray(a) for a in args)
        promise = JPromise(kw.get("promise", Promise.CRW if kind == "insert"
                                  else Promise.CR).value)
        if kw["backend"] == "rpc":
            if kind == "insert":
                ht, ok, probes = j_insert_rpc(ht, engine, *args)
                outs.append((ok, probes))
            else:
                outs.append(j_find_rpc(ht, engine, *args))
            continue
        flags = dict(fused=kw.get("fused", True),
                     coalesce=kw.get("coalesce", False))
        if kind == "insert":
            ht, ok, probes = j_insert(ht, *args, promise=promise, **flags)
            outs.append((ok, probes))
        else:
            ht, found, vals = j_find(ht, *args, promise=promise, **flags)
            outs.append((found, vals))
    return ht, outs


def _same_outs(got, want, what):
    for x, y in zip(got, want, strict=True):
        same(x, y, what)


def _submit(pipe, ops):
    handles = []
    for kind, args, kw in ops:
        fn = ht_mod.insert_async if kind == "insert" else ht_mod.find_async
        handles.append(fn(pipe, *args, **kw))
    return handles


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_depth_equals_sync_and_jax(depth):
    """insert_async / find_async == insert / find in submission order ==
    the JAX package, at any depth, final window included."""
    rng = np.random.default_rng(depth)
    k1, v1 = _batch(rng)
    k2, v2 = _batch(rng)
    ops = [("insert", (k1, v1), {"backend": "rdma"}),
           ("find", (k1,), {"backend": "rdma"}),
           ("insert", (k2, v2), {"backend": "rdma", "fused": False}),
           ("find", (k2,), {"backend": "rdma", "promise": Promise.CRW})]
    ht0 = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    pipe = pl_mod.Pipeline(ht0, depth=depth)
    handles = _submit(pipe, ops)
    assert pipe.in_flight == min(depth - 1, len(ops))
    ht_sync, outs = _port_replay(ht0, ops)
    ht_jax, jouts = _jax_replay(ops)
    for h, o, jo in zip(handles, outs, jouts):
        assert h.done()       # nothing is in flight on the CPU
        _same_outs(h.result(), o, f"depth={depth} seq={h.seq} sync")
        _same_outs(h.result(), jo, f"depth={depth} seq={h.seq} jax")
    final = pipe.flush()
    assert pipe.in_flight == 0
    same(final.win.data, ht_sync.win.data, "window vs sync")
    same(final.win.data, ht_jax.win.data, "window vs jax")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_randomized_out_of_order_forcing(seed):
    """A randomized interleaved stream (duplicate keys, fused / unfused /
    coalesced arms) forced in RANDOM order: every handle and the final
    window equal the in-order synchronous replay and the JAX package."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(6):
        dup = bool(rng.integers(0, 2))
        k, v = _batch(rng, dup=dup)
        kw = {"backend": "rdma", "fused": bool(rng.integers(0, 2))}
        if kw["fused"] and dup:
            kw["coalesce"] = bool(rng.integers(0, 2))
        if rng.integers(0, 2):
            ops.append(("insert", (k, v), kw))
        else:
            ops.append(("find", (k,), kw))
    ht0 = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    pipe = pl_mod.Pipeline(ht0, depth=2)
    handles = _submit(pipe, ops)
    ht_sync, outs = _port_replay(ht0, ops)
    ht_jax, jouts = _jax_replay(ops)
    order = rng.permutation(len(handles))
    for i in order:
        _same_outs(handles[i].result(), outs[i], f"op {i} sync")
        _same_outs(handles[i].result(), jouts[i], f"op {i} jax")
    _same_outs(handles[int(order[0])].result(), outs[int(order[0])],
               "repeated result()")
    final = pipe.flush()
    same(final.win.data, ht_sync.win.data)
    same(final.win.data, ht_jax.win.data)


@pytest.mark.parametrize("depth", [1, 2])
def test_deferred_am_dispatch_points(depth):
    """AM-arm submissions queue on the AMEngine and drain at the next
    dispatch point (eager submit / result / flush); values and window
    equal the synchronous replay and the JAX package."""
    rng = np.random.default_rng(7)
    k1, v1 = _batch(rng)
    k2, _ = _batch(rng)
    ht0 = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    eng = am_mod.AMEngine(P)
    ht_mod.build_am_handlers(ht0, eng)
    pipe = pl_mod.Pipeline(ht0, depth=depth, am_engine=eng)
    pts0 = eng.dispatch_points
    h1 = ht_mod.insert_async(pipe, k1, v1, backend="rpc")
    if depth == 1:
        assert pipe.pending_deferred == 0      # submit forced it already
        assert h1.done()
    else:
        assert pipe.pending_deferred == 1
        assert not h1.done()
    h2 = ht_mod.find_async(pipe, k1, backend="rdma")  # eager: dispatch point
    assert pipe.pending_deferred == 0
    assert eng.dispatch_points > pts0
    h3 = ht_mod.find_async(pipe, k2, backend="rpc")   # queued (depth > 1)
    out3 = h3.result()                                # a dispatch point
    assert pipe.pending_deferred == 0
    ops = [("insert", (k1, v1), {"backend": "rpc"}),
           ("find", (k1,), {"backend": "rdma"}),
           ("find", (k2,), {"backend": "rpc"})]
    eng_s = am_mod.AMEngine(P)
    ht_mod.build_am_handlers(ht0, eng_s)
    ht_sync, outs = _port_replay(ht0, ops, engine=eng_s)
    ht_jax, jouts = _jax_replay(ops, engine=jam.AMEngine(P))
    for got, o, jo in zip((h1.result(), h2.result(), out3), outs, jouts):
        _same_outs(got, o, "sync")
        _same_outs(got, jo, "jax")
    final = pipe.flush()
    same(final.win.data, ht_sync.win.data)
    same(final.win.data, ht_jax.win.data)


def test_queue_async_conformance():
    rng = np.random.default_rng(3)
    v1 = rng.integers(1, 100, (P, 6, VW)).astype(np.int32)
    v2 = rng.integers(1, 100, (P, 6, VW)).astype(np.int32)
    q0 = q_mod.make_queue(P, 0, 64, VW, device="cpu")
    pipe = pl_mod.Pipeline(q0, depth=2)
    h1 = q_mod.push_async(pipe, v1, backend="rdma")
    h2 = q_mod.pop_async(pipe, 4, backend="rdma")
    h3 = q_mod.push_async(pipe, v2, backend="rdma")
    h4 = q_mod.pop_async(pipe, 8, backend="rdma")
    q_s, ok1 = q_mod.push(q0, torch.as_tensor(v1), backend="rdma")
    q_s, got2, vals2 = q_mod.pop(q_s, 4, backend="rdma")
    q_s, ok3 = q_mod.push(q_s, torch.as_tensor(v2), backend="rdma")
    q_s, got4, vals4 = q_mod.pop(q_s, 8, backend="rdma")
    jqs = jq.make_queue(P, 0, 64, VW)
    crw, cr = JPromise.CRW, JPromise.CR
    jqs, jok1 = j_push(jqs, jnp.asarray(v1), promise=crw)
    jqs, jgot2, jvals2 = j_pop(jqs, n=4, promise=cr)
    jqs, jok3 = j_push(jqs, jnp.asarray(v2), promise=crw)
    jqs, jgot4, jvals4 = j_pop(jqs, n=8, promise=cr)
    for h, o, jo in ((h4, (got4, vals4), (jgot4, jvals4)),   # out of order
                     (h1, (ok1,), (jok1,)), (h3, (ok3,), (jok3,)),
                     (h2, (got2, vals2), (jgot2, jvals2))):
        r = h.result()
        r = r if isinstance(r, tuple) else (r,)
        _same_outs(r, o, f"seq {h.seq} sync")
        _same_outs(r, jo, f"seq {h.seq} jax")
    final = pipe.flush()
    same(final.win.data, q_s.win.data)
    same(final.win.data, jqs.win.data)


def test_auto_backend_async_matches_jax():
    """backend AUTO through both packages' pipelines (model decisions,
    depth pricing on, the same calibrated parameters): the same
    Decisions field by field, the same deferral, the same values."""
    rng = np.random.default_rng(11)
    k1, v1 = _batch(rng)
    params = jcm.CORI_PHASE1
    jt = jht.make_hashtable(P, NSLOTS, VW)
    jeng = jam.AMEngine(P)
    jht.build_am_handlers(jt, jeng)
    ja = jad.AdaptiveEngine(P, am_engine=jeng, params=params)
    jpipe = jpl.Pipeline(jt, depth=2, am_engine=jeng)
    jh = [jht.insert_async(jpipe, jnp.asarray(k1), jnp.asarray(v1),
                           adaptive=ja),
          jht.find_async(jpipe, jnp.asarray(k1), adaptive=ja)]
    jouts = [h.result() for h in jh]

    tt = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    teng = am_mod.AMEngine(P)
    ht_mod.build_am_handlers(tt, teng)
    ta = ad.AdaptiveEngine(P, am_engine=teng, params=convert.component_costs(
        dataclasses.asdict(params)))
    tpipe = pl_mod.Pipeline(tt, depth=2, am_engine=teng)
    th = [ht_mod.insert_async(tpipe, k1, v1, adaptive=ta),
          ht_mod.find_async(tpipe, k1, adaptive=ta)]
    assert [h.deferred for h in th] == [h.deferred for h in jh]
    for h, jo in zip(th, jouts):
        _same_outs(h.result(), jo, f"seq {h.seq}")
    assert len(ta.log) == len(ja.log) == 2
    for i, (td, jd) in enumerate(zip(ta.log, ja.log)):
        assert td.depth == 2 and td.skew >= 1.0
        same_decision(td, jd, i)
    same(tpipe.flush().win.data, jpipe.flush().win.data)


def test_pipeline_depth_validation():
    with pytest.raises(ValueError):
        pl_mod.Pipeline(ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu"),
                        depth=0)


# ---------------------------------------------------------------------------
# Slot-tagged phase log + exchange counts
# ---------------------------------------------------------------------------
def _put_get_inputs():
    rng = np.random.default_rng(0)
    dst = rng.integers(0, P, (P, 6)).astype(np.int32)
    off = rng.integers(0, 16, (P, 6)).astype(np.int32)
    return dst, off


def _port_op(dst, off):
    dst, off = torch.as_tensor(dst), torch.as_tensor(off)
    vals = torch.ones((P, 6, 1), dtype=torch.int32)

    def op(w):
        w2 = window.rdma_put(w, dst, off, vals)
        return w2, window.rdma_get(w2, dst, off, 1)
    return op


@pytest.fixture(scope="module")
def jax_phase_trace():
    """The JAX package's slot-tagged phase log and exchange roles for two
    put+get batches at depth 2 (eager: both record at trace time)."""
    dst, off = (jnp.asarray(x) for x in _put_get_inputs())
    vals = jnp.ones((P, 6, 1), jnp.int32)

    def op(w):
        w2 = jwin.rdma_put(w, dst, off, vals)
        return w2, jwin.rdma_get(w2, dst, off, 1)

    roles = []

    def hook(x, role):
        roles.append(role)
        return x

    jwin.drain_phase_log()
    from repro.core import routing as jrouting
    with jrouting.sharding_hook(hook):
        pipe = jpl.Pipeline(jwin.make_window(P, 32), depth=2)
        pipe.submit(op)
        pipe.submit(op)
        w = pipe.flush()
    log = jwin.drain_phase_log()
    tags = [(role, info["slot"], info["seq"]) for role, _, info in log]
    return tags, roles, np.asarray(w.data)


def test_slot_tagged_phase_log_matches_jax(jax_phase_trace):
    """Every phase run inside a pipeline slot carries {slot, seq}; two
    windows alternate slots 0/1 at depth 2, as in the JAX package."""
    jtags, _, jdata = jax_phase_trace
    op = _port_op(*_put_get_inputs())
    window.drain_phase_log()
    pipe = pl_mod.Pipeline(window.make_window(P, 32, device="cpu"), depth=2)
    pipe.submit(op)
    pipe.submit(op)
    w = pipe.flush()
    log = window.drain_phase_log()
    tags = [(role, info["slot"], info["seq"]) for role, _, info in log]
    assert tags == jtags == [("put", 0, 0), ("get", 0, 0),
                             ("put", 1, 1), ("get", 1, 1)]
    same(w.data, jdata)


def test_pipelining_adds_zero_exchanges(jax_phase_trace):
    """A depth-2 stream makes exactly the exchanges of the same batches
    run synchronously, with the JAX package's roles."""
    _, jroles, _ = jax_phase_trace
    op = _port_op(*_put_get_inputs())
    roles = []

    def hook(x, role):
        roles.append(role)
        return x

    w0 = window.make_window(P, 32, device="cpu")
    with routing.sharding_hook(hook):
        w = w0
        for _ in range(2):
            w, _ = op(w)
    sync_roles = list(roles)
    roles.clear()
    with routing.sharding_hook(hook):
        pipe = pl_mod.Pipeline(w0, depth=2)
        pipe.submit(op)
        pipe.submit(op)
        pipe.flush()
    assert roles == sync_roles == jroles
    assert any(r.endswith("_pre") for r in roles)


# ---------------------------------------------------------------------------
# auto_depth
# ---------------------------------------------------------------------------
def test_auto_depth_retargets_like_jax():
    """Pipeline(auto_depth=True): the async front doors let the chooser
    set the window count (capped at the constructor depth), pricing the
    Decision at it, as the JAX package's choose_depth would."""
    rng = np.random.default_rng(5)
    params = jcm.CORI_PHASE1
    ta = ad.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P),
                           params=convert.component_costs(
                               dataclasses.asdict(params)))
    ja = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P), params=params)
    for arm, cap, busy in (("am", 3, 4.0), ("am", 1, 4.0),
                           ("rdma_fused", 3, 0.0), ("am_pt", 4, 40.0)):
        ta.force_arm = ja.force_arm = arm
        for op, promise in ((cm.DSOp.HT_INSERT, Promise.CRW),
                            (cm.DSOp.Q_POP, Promise.CR)):
            tp = pl_mod.Pipeline(object(), depth=cap, auto_depth=True)
            jp = jpl.Pipeline(object(), depth=cap, auto_depth=True)
            ts = ta.auto_depth(tp, op, promise, OpStats(target_busy_us=busy))
            js = ja.auto_depth(jp, jcm.DSOp(op.value), JPromise(promise.value),
                               JOpStats(target_busy_us=busy))
            assert tp.depth == jp.depth == ts.pipeline_depth \
                == js.pipeline_depth, (arm, cap, op)
            assert 1 <= tp.depth <= cap
    # end to end: an AM-priced insert stream retargets a depth-3 pipeline
    ht0 = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    eng = am_mod.AMEngine(P)
    ta = ad.AdaptiveEngine(P, am_engine=eng)
    ta.force_arm = "am"
    pipe = pl_mod.Pipeline(ht0, depth=3, am_engine=eng, auto_depth=True)
    hs = []
    for _ in range(3):
        k, v = _batch(rng)
        hs.append(ht_mod.insert_async(pipe, k, v, adaptive=ta,
                                      stats=OpStats(target_busy_us=5.0)))
        assert pipe.depth == 2 and pipe.in_flight <= 1
    pipe.flush()
    assert all(h.done() for h in hs)
    assert [d.depth for d in ta.log] == [2, 2, 2]


def test_set_depth_clamps_and_forces():
    rng = np.random.default_rng(6)
    ht0 = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    eng = am_mod.AMEngine(P)
    ht_mod.build_am_handlers(ht0, eng)
    pipe = pl_mod.Pipeline(ht0, depth=3, am_engine=eng)
    hs = [ht_mod.insert_async(pipe, *_batch(rng), backend="rpc")
          for _ in range(2)]
    assert pipe.in_flight == 2 and pipe.pending_deferred == 2
    assert pipe in window._INFLIGHT_PIPES and window.pipeline_inflight()
    pipe.set_depth(10)                     # clamped to the cap
    assert pipe.depth == 3 and pipe.in_flight == 2
    pipe.set_depth(0)                      # clamped to 1: forces both
    assert pipe.depth == 1 and pipe.in_flight == 0
    assert pipe.pending_deferred == 0 and all(h.done() for h in hs)
    assert pipe not in window._INFLIGHT_PIPES
