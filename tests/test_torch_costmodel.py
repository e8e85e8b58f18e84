"""The cost model against the JAX package's: every ported function, over a
grid of ops x promises x backends and arms x OpStats, on three parameter
sets carried to both packages (the paper's CORI_PHASE1; the JAX package's
TPU constants, carried across here with `convert.component_costs` only
because the port keeps no TPU numbers; a calibrated set with P-slopes, a
retry penalty and fused overrides). Both compute the same floats in the
same order, so predictions are compared with ==. Then the orderings of
tests/test_costmodel_ordering.py and the promise-ordering property of
tests/test_properties.py (with DSOp.TXN given its own weak promise), on
the port.
"""
import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import costmodel as jcm
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import costmodel as cm
from repro_torch.core.types import Backend, OpStats, Promise

_CAL = {"W": 0.75, "R": 1.25, "A_cas": 1.5, "A_fao": 1.75, "am_rt": 2.25,
        "handler": 0.125, "amo_apply": 0.0625, "A_cas_put": 1.625,
        "A_cas_put_pub": 1.875, "A_fao_get": 2.0, "combine": 0.03125,
        "cache_lookup": 0.1875, "pipe_depth_overhead": 0.4,
        "exch_per_rank": 0.025, "fanout_per_rank": 0.001,
        "retry_penalty": 0.7}
JAX_SETS = {"cori": jcm.CORI_PHASE1, "tpu": jcm.TPU_V5E_ICI,
            "calibrated": jcm.calibrate(_CAL, base=jcm.TPU_V5E_ICI)}
STATS = [
    dict(),
    dict(expected_probes=2.5, contention=3.0),
    dict(skew=8.0, nranks=8),
    dict(skew=3.0, dedup=0.25, expected_probes=2.0),
    dict(target_busy_us=4.0),
    dict(target_busy_us=4.0, progress_thread=True),
    dict(hit_rate=0.6, dedup=0.5),
    dict(pipeline_depth=2, skew=4.0, target_busy_us=2.0),
    dict(pipeline_depth=4, skew=2.0),
    dict(nranks=64, loss_rate=0.1),
    dict(abort_rate=0.3, ops_per_rank=4, skew=2.0),
    dict(loss_rate=0.99, abort_rate=0.97, dedup=0.0005, nranks=256),
    dict(ops_per_rank=3, dedup=0.4, pipeline_depth=2, hit_rate=1.5),
]
OPS = [op.value for op in cm.DSOp]
PROMISES = [p.value for p in Promise]


def _sets(name):
    j = JAX_SETS[name]
    return j, convert.component_costs(dataclasses.asdict(j))


def _stats(kw):
    return jtypes.OpStats(**kw), OpStats(**kw)


def _run(fn):
    try:
        r = fn()
    except (ValueError, KeyError) as e:
        return None, type(e)
    return (r.value if hasattr(r, "value") else r), None


def check(jfn, tfn, what):
    """The port's result equals the JAX package's (floats with ==), or
    both raise the same exception type."""
    assert _run(tfn) == _run(jfn), what


def test_parameter_sets_carry_across():
    assert dataclasses.asdict(cm.CORI_PHASE1) == dataclasses.asdict(
        jcm.CORI_PHASE1)
    for name in JAX_SETS:
        j, t = _sets(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for acc in ("fused_cas_put", "fused_cas_put_pub", "fused_fao_get"):
            assert getattr(t, acc)() == getattr(j, acc)()
    assert cm.ARMS == jcm.ARMS and OPS == [op.value for op in jcm.DSOp]
    assert (cm.PIPELINE_STAGES, cm.DEPTH_CANDIDATES, cm.PLAN_EXCHANGES) == (
        jcm.PIPELINE_STAGES, jcm.DEPTH_CANDIDATES, jcm.PLAN_EXCHANGES)
    assert not hasattr(cm, "TPU_V5E_ICI")
    assert cm.H100_SXM.name == "h100-sxm" and cm.H100_SXM.handler == 0.0


@pytest.mark.parametrize("name", list(JAX_SETS))
@pytest.mark.parametrize("op", OPS)
def test_predict_matches_jax(name, op):
    """predict with every backend and fused / coalesce / cached flag, and
    attentiveness_delay, _p_scaled and predict_checksum_push."""
    jp, tp = _sets(name)
    jo, to = jcm.DSOp(op), cm.DSOp(op)
    for kw in STATS:
        js, ts = _stats(kw)
        check(lambda: jcm.attentiveness_delay(jp, js),
              lambda: cm.attentiveness_delay(tp, ts), kw)
        assert dataclasses.asdict(cm._p_scaled(tp, ts)) == \
            dataclasses.asdict(jcm._p_scaled(jp, js))
        assert cm.predict_checksum_push(ts, tp) == \
            jcm.predict_checksum_push(js, jp)
        for pr in PROMISES:
            for be in ("rdma", "rpc", "auto"):
                for fused in (False, True):
                    for co in (False, True):
                        for ca in (False, True):
                            check(lambda: jcm.predict(
                                jo, jtypes.Promise(pr), jtypes.Backend(be),
                                js, jp, fused=fused, coalesce=co, cached=ca),
                                lambda: cm.predict(
                                    to, Promise(pr), Backend(be), ts, tp,
                                    fused=fused, coalesce=co, cached=ca),
                                (name, op, pr, be, fused, co, ca, kw))


@pytest.mark.parametrize("name", list(JAX_SETS))
@pytest.mark.parametrize("op", OPS)
def test_arms_and_choosers_match_jax(name, op):
    """predict_arm, _predict_arm_flat, overlap_split, predict_pipelined at
    every depth, choose_depth (ladder and max_depth), choose_backend, and
    the coalesce and cache rules, per arm and promise."""
    jp, tp = _sets(name)
    jo, to = jcm.DSOp(op), cm.DSOp(op)
    for kw in STATS:
        js, ts = _stats(kw)
        for pr in PROMISES:
            jpr, tpr = jtypes.Promise(pr), Promise(pr)
            for fused in (False, True):
                check(lambda: jcm.choose_backend(jo, jpr, js, jp, fused),
                      lambda: cm.choose_backend(to, tpr, ts, tp, fused),
                      (name, op, pr, fused, kw))
            for arm in cm.ARMS:
                assert cm.arm_coalesces(to, arm, ts.dedup) == \
                    jcm.arm_coalesces(jo, arm, js.dedup)
                assert cm.arm_caches(to, tpr, arm) == \
                    jcm.arm_caches(jo, jpr, arm)
                cases = [
                    (lambda: cm.predict_arm(to, tpr, arm, ts, tp),
                     lambda: jcm.predict_arm(jo, jpr, arm, js, jp)),
                    (lambda: cm._predict_arm_flat(to, tpr, arm, ts, tp),
                     lambda: jcm._predict_arm_flat(jo, jpr, arm, js, jp)),
                    (lambda: cm.overlap_split(to, tpr, arm, ts, tp),
                     lambda: jcm.overlap_split(jo, jpr, arm, js, jp)),
                    (lambda: cm.choose_depth(to, tpr, arm, ts, tp),
                     lambda: jcm.choose_depth(jo, jpr, arm, js, jp)),
                    (lambda: cm.choose_depth(to, tpr, arm, ts, tp,
                                             candidates=(4, 2, 3, 0),
                                             max_depth=3),
                     lambda: jcm.choose_depth(jo, jpr, arm, js, jp,
                                              candidates=(4, 2, 3, 0),
                                              max_depth=3)),
                ] + [(lambda d=d: cm.predict_pipelined(to, tpr, arm, ts, tp,
                                                       depth=d),
                      lambda d=d: jcm.predict_pipelined(jo, jpr, arm, js, jp,
                                                        depth=d))
                     for d in (None, 1, 2, 3, 4, 8)]
                for tfn, jfn in cases:
                    check(jfn, tfn, (name, op, pr, arm, kw))
    with pytest.raises(ValueError):
        cm.predict_arm(to, Promise.CR, "nope", params=tp)


@pytest.mark.parametrize("fused", [False, True])
def test_phase_and_exchange_counts_match_jax(fused):
    for op in OPS:
        for pr in PROMISES:
            for be in ("rdma", "rpc"):
                check(lambda: jcm.network_phases(
                    jcm.DSOp(op), jtypes.Promise(pr), jtypes.Backend(be),
                    fused),
                    lambda: cm.network_phases(
                        cm.DSOp(op), Promise(pr), Backend(be), fused),
                    (op, pr, be))
                for probes in (1, 3):
                    check(lambda: jcm.exchange_count(
                        jcm.DSOp(op), jtypes.Promise(pr),
                        jtypes.Backend(be), fused, probes),
                        lambda: cm.exchange_count(
                            cm.DSOp(op), Promise(pr), Backend(be), fused,
                            probes),
                        (op, pr, be, probes))


def test_calibrate_matches_jax():
    for base in ("cori", "tpu", "calibrated"):
        jb, tb = _sets(base)
        for measured in (_CAL, {"W": 9.0, "not_a_component": 1.0},
                         {"A_cas": 2.0, "A_fao": 2.25}, {}):
            assert dataclasses.asdict(cm.calibrate(measured, tb)) == \
                dataclasses.asdict(jcm.calibrate(measured, jb))
    assert dataclasses.asdict(cm.calibrate(_CAL)) == dataclasses.asdict(
        jcm.calibrate(_CAL))


def test_model_layer_choosers_match_jax():
    for tokens in (1, 64, 4096):
        kw = dict(tokens_per_rank=tokens, d_model=2048,
                  expert_bytes_per_rank=2 ** 24)
        assert cm.choose_moe_backend(**kw).value == \
            jcm.choose_moe_backend(**kw).value
        for be in ("rdma", "rpc"):
            assert cm.moe_dispatch_bytes(Backend(be), **kw) == \
                jcm.moe_dispatch_bytes(jtypes.Backend(be), **kw)
    for kv in (2 ** 10, 2 ** 24):
        kw = dict(kv_bytes_per_shard=kv, q_heads=16, head_dim=128, shards=4)
        assert cm.choose_attention_backend(**kw).value == \
            jcm.choose_attention_backend(**kw).value


# ---------------------------------------------------------------------------
# The orderings of tests/test_costmodel_ordering.py, on the port
# ---------------------------------------------------------------------------
ORDER_SETS = ["cori", "tpu"]
ATTENTIVE = OpStats(target_busy_us=0.0)


def _params(name):
    return _sets(name)[1]


@pytest.mark.parametrize("name", ORDER_SETS)
def test_fig5_hashtable_ordering(name):
    p = _params(name)
    D = cm.DSOp

    def pr(op, promise, be):
        return cm.predict(op, promise, be, ATTENTIVE, p)
    assert (pr(D.HT_FIND, Promise.CR, Backend.RDMA)
            < pr(D.HT_FIND, Promise.CRW, Backend.RPC)
            < pr(D.HT_FIND, Promise.CRW, Backend.RDMA))
    ins_crw = pr(D.HT_INSERT, Promise.CRW, Backend.RDMA)
    assert pr(D.HT_INSERT, Promise.CRW, Backend.RPC) < ins_crw
    assert pr(D.HT_INSERT, Promise.CW, Backend.RDMA) < ins_crw


@pytest.mark.parametrize("name", ORDER_SETS)
def test_fig4_queue_ordering(name):
    p = _params(name)
    D = cm.DSOp
    local = cm.predict(D.Q_PUSH, Promise.CL, Backend.RDMA, ATTENTIVE, p)
    cw = cm.predict(D.Q_PUSH, Promise.CW, Backend.RDMA, ATTENTIVE, p)
    crw = cm.predict(D.Q_PUSH, Promise.CRW, Backend.RDMA, ATTENTIVE, p)
    csum = cm.predict_checksum_push(ATTENTIVE, p)
    am = cm.predict(D.Q_PUSH, Promise.CRW, Backend.RPC, ATTENTIVE, p)
    assert local < cw <= crw
    assert csum == pytest.approx(cw)
    assert csum < crw and am < crw


@pytest.mark.parametrize("name", ORDER_SETS)
def test_attentiveness_flips_insert_winner(name):
    p = _params(name)
    D = cm.DSOp
    assert cm.choose_backend(D.HT_INSERT, Promise.CRW, ATTENTIVE,
                             p) == Backend.RPC
    busy = OpStats(target_busy_us=1000.0)
    assert cm.choose_backend(D.HT_INSERT, Promise.CRW, busy,
                             p) == Backend.RDMA
    pt = OpStats(target_busy_us=1000.0, progress_thread=True)
    assert (cm.predict(D.HT_INSERT, Promise.CRW, Backend.RPC, pt, p)
            < cm.predict(D.HT_INSERT, Promise.CRW, Backend.RPC, busy, p))


@pytest.mark.parametrize("name", ORDER_SETS)
def test_fused_engine_never_costs_more(name):
    p = _params(name)
    D = cm.DSOp
    for op, promise in ((D.HT_INSERT, Promise.CRW), (D.HT_INSERT, Promise.CW),
                        (D.HT_FIND, Promise.CRW)):
        assert (cm.predict(op, promise, Backend.RDMA, ATTENTIVE, p,
                           fused=True)
                <= cm.predict(op, promise, Backend.RDMA, ATTENTIVE, p))
    assert (cm.predict(D.HT_FIND, Promise.CR, Backend.RDMA, ATTENTIVE, p)
            < cm.predict(D.HT_FIND, Promise.CRW, Backend.RDMA, ATTENTIVE, p,
                         fused=True))


@pytest.mark.parametrize("name", ORDER_SETS)
def test_coalesced_prediction_cheaper_under_duplicates(name):
    p = _params(name)
    D = cm.DSOp
    for op, promise in ((D.HT_INSERT, Promise.CRW), (D.HT_INSERT, Promise.CW),
                        (D.HT_FIND, Promise.CRW), (D.HT_FIND, Promise.CR)):
        prev = None
        for rho in (0.8, 0.5, 0.2, 0.05):
            s = OpStats(expected_probes=2.0, skew=4.0, dedup=rho)
            co = cm.predict(op, promise, Backend.RDMA, s, p, fused=True,
                            coalesce=True)
            assert co < cm.predict(op, promise, Backend.RDMA, s, p,
                                   fused=True)
            assert prev is None or co <= prev
            prev = co


@pytest.mark.parametrize("name", ORDER_SETS)
def test_predict_arm_prices_dedup_and_matches_predict(name):
    p = _params(name)
    D = cm.DSOp
    dup = OpStats(expected_probes=2.0, skew=4.0, dedup=0.25)
    uni = dataclasses.replace(dup, dedup=1.0)
    for op, promise in ((D.HT_INSERT, Promise.CRW), (D.HT_FIND, Promise.CR)):
        for arm, cmp in (("rdma_fused", "<"), ("rdma", "=="), ("am", "<")):
            a = cm.predict_arm(op, promise, arm, dup, p)
            b = cm.predict_arm(op, promise, arm, uni, p)
            assert a < b if cmp == "<" else a == b
    s = OpStats(target_busy_us=4.0)
    assert cm.predict_arm(D.Q_POP, Promise.CR, "rdma", s, p) == cm.predict(
        D.Q_POP, Promise.CR, Backend.RDMA, s, p)
    am = cm.predict_arm(D.HT_INSERT, Promise.CRW, "am", s, p)
    pt = cm.predict_arm(D.HT_INSERT, Promise.CRW, "am_pt", s, p)
    assert am == cm.predict(D.HT_INSERT, Promise.CRW, Backend.RPC, s, p)
    assert pt == cm.predict(D.HT_INSERT, Promise.CRW, Backend.RPC,
                            dataclasses.replace(s, progress_thread=True), p)
    assert am != pt


@pytest.mark.parametrize("name", ORDER_SETS)
def test_choose_depth_model_pins(name):
    p = _params(name)
    D = cm.DSOp
    assert cm.choose_depth(D.HT_FIND, Promise.CR, "rdma_fused", OpStats(),
                           p) == 1
    busy = OpStats(skew=4.0, target_busy_us=4.0)
    for op in (D.HT_INSERT, D.Q_PUSH):
        assert cm.choose_depth(op, Promise.CRW, "am", busy, p) == 2
    for op in (D.HT_INSERT, D.HT_FIND, D.Q_PUSH, D.Q_POP):
        for arm in cm.ARMS:
            assert cm.choose_depth(op, Promise.CRW, arm, OpStats(skew=4.0),
                                   p) != 4
    assert cm.choose_depth(D.HT_INSERT, Promise.CRW, "am", busy, p,
                           max_depth=1) == 1


def test_p_scaling_orderings():
    """The P-dependence pins: zero slopes are bit-identical at any P,
    positive slopes grow every arm with P, and the fused insert loses to
    the AM insert from P = 64 on."""
    scaled = cm.calibrate(
        {"W": 1.0, "R": 1.8, "A_cas": 1.6, "A_fao": 1.6, "am_rt": 2.8,
         "handler": 0.1, "amo_apply": 0.2, "exch_per_rank": 0.025,
         "fanout_per_rank": 0.001}, base=_params("tpu"))
    D = cm.DSOp
    for name in ORDER_SETS:
        blind = cm.predict_arm(D.HT_INSERT, Promise.CRW, "rdma_fused",
                               OpStats(nranks=0), _params(name))
        for p in (8, 64, 256):
            assert cm.predict_arm(D.HT_INSERT, Promise.CRW, "rdma_fused",
                                  OpStats(nranks=p), _params(name)) == blind

    def ins(arm, p):
        return cm.predict_arm(D.HT_INSERT, Promise.CRW, arm,
                              OpStats(nranks=p), scaled)
    for arm in cm.ARMS:
        assert ins(arm, 1) < ins(arm, 8) < ins(arm, 64) < ins(arm, 256)
    assert ins("rdma_fused", 8) < ins("am", 8)
    assert ins("am", 64) < ins("rdma_fused", 64) < ins("rdma", 64)


# ---------------------------------------------------------------------------
# The promise-ordering property of tests/test_properties.py. The JAX test
# samples DSOp.TXN but its weak-promise table has no TXN entry (a KeyError
# there); a transaction's weak promise here is C_W, its phasal write set.
# ---------------------------------------------------------------------------
WEAK = {cm.DSOp.HT_INSERT: Promise.CW, cm.DSOp.HT_FIND: Promise.CR,
        cm.DSOp.Q_PUSH: Promise.CW, cm.DSOp.Q_POP: Promise.CR,
        cm.DSOp.TXN: Promise.CW}


@settings(max_examples=20, deadline=None)
@given(st.sampled_from(list(cm.DSOp)), st.floats(0.1, 10.0),
       st.floats(0.1, 10.0), st.sampled_from(["cori", "tpu", "calibrated"]))
def test_costmodel_promise_ordering(op, probes, contention, name):
    """Stronger promises never cost less: C_RW >= the phasal variant."""
    s = OpStats(expected_probes=probes, contention=contention)
    p = _params(name)
    assert (cm.predict(op, Promise.CRW, Backend.RDMA, s, p)
            >= cm.predict(op, WEAK[op], Backend.RDMA, s, p))
