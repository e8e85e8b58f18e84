"""The paper's analytical cost model (Tables I-III) as code, with the
divergence terms of DESIGN.md and the backend auto-chooser (port of
`repro.core.costmodel`, every function computing the same float in the
same order).

Every data-structure method cost is a sum of *component* costs. Component
costs come from one of three parameter sets:

- ``CORI_PHASE1``: the paper's measured Aries numbers (Table I), to
  reproduce the paper's predictions exactly;
- ``H100_SXM``: fitted with ``calibrate`` from the component timings of
  `chip_smoke.py` phase 10 on one H100, the port's default prior;
- ``calibrate(measured)``: fitted from any other component timings (the
  paper's Figs. 4-5 predicted-vs-measured method).

The model's real claim is that it *orders* implementations correctly, not
that absolute microseconds match. The last part holds the model-layer
choosers: the same move-data-vs-move-compute decision for serving.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from .types import Backend, OpStats, Promise


@dataclass(frozen=True)
class ComponentCosts:
    """Latency (µs) of each component operation. Paper Table I notation,
    extended with the fused component descriptors of DESIGN.md §2."""

    W: float            # remote put
    R: float            # remote get
    A_cas: float        # atomic compare-and-swap
    A_fao: float        # atomic fetch-and-op
    am_rt: float        # active-message round trip (attentive target)
    handler: float      # target-side handler compute, per op (amortized)
    local: float = 0.05         # ell: local push/pop
    amo_apply: float = 0.0      # owner-lane serialized-apply term
    pt_overhead: float = 1.35   # progress-thread contention factor (Fig. 6 PT)
    combine: float = 0.05       # sender-side coalescing overhead per op
                                # (duplicate-run lexsort + reply fan-out,
                                # DESIGN.md §6) — paid whether or not the
                                # batch actually contains duplicates
    cache_lookup: float = 0.15  # hot-bucket cache consult per op (DESIGN.md
                                # §8): the host-side tag+version check every
                                # cached-arm op pays, hit or miss
    pipe_depth_overhead: float = 0.0
                                # per-op penalty for each pipeline window
                                # beyond PIPELINE_STAGES (DESIGN.md §7): the
                                # engine has two stages, so depth > 2 adds
                                # queueing/host-scheduling overhead instead
                                # of overlap (the depth-4 regression the
                                # JAX package measured on the CPU,
                                # BENCH_trajectory.json).
                                # 0.0 = pure saturation; calibrate() sets
                                # the measured slope.
    # P-dependence (DESIGN.md §9). Both default to 0.0 so every fixed-P
    # prediction (and any calibrated set that does not measure them) stays
    # bit-identical to the P-blind model; the JAX package's scaling_bench
    # fits the slopes (the port has no P sweep yet).
    exch_per_rank: float = 0.0
                                # fractional growth of each one-sided wire
                                # term per additional owner: the occupancy
                                # exchange and the request/reply all-to-alls
                                # are O(P) lanes wide, so each one-sided
                                # component costs
                                # base * (1 + exch_per_rank * (P - 1))
    fanout_per_rank: float = 0.0
                                # fractional growth of the AM round trip per
                                # additional owner: the handler reply
                                # fan-out crosses more lanes as the owner
                                # count grows, scaling am_rt by
                                # 1 + fanout_per_rank * (P - 1)
    retry_penalty: float = 0.0  # fixed per-retransmission overhead
                                # (DESIGN.md §10): timeout detection +
                                # backoff + re-submit bookkeeping charged on
                                # top of the re-sent unit's wire cost. Under
                                # OpStats.loss_rate = lr each op expects
                                # lr/(1-lr) retransmissions; the AM arms
                                # re-send a whole round trip (am_rt) while
                                # the one-sided arms re-send one phase
                                # (0.5 * W) — the asymmetry that flips the
                                # trade toward RDMA under loss. 0.0 keeps
                                # every lossless prediction bit-identical.
    # Fused component phases (None -> derived: the compound descriptor rides
    # the atomic's two exchanges, so a fused op costs its atomic; the saved
    # W / R / A_fao phases are the win). calibrate() overrides with measured
    # numbers from the component timings (chip_smoke.py phase 10).
    A_cas_put: Optional[float] = None      # claim + record write
    A_cas_put_pub: Optional[float] = None  # claim + write + publish flip
    A_fao_get: Optional[float] = None      # fetch-and-op + record gather
    name: str = "unnamed"

    def fused_cas_put(self) -> float:
        return self.A_cas if self.A_cas_put is None else self.A_cas_put

    def fused_cas_put_pub(self) -> float:
        return (self.A_cas if self.A_cas_put_pub is None
                else self.A_cas_put_pub)

    def fused_fao_get(self) -> float:
        return self.A_fao if self.A_fao_get is None else self.A_fao_get


# Paper Table I (Cori Phase I, Cray Aries, 64 nodes). am_rt from Fig. 3's AM
# curve sitting between R and the persistent-CAS cluster. Aries NICs have no
# fused descriptors; the derived defaults model what Storm-style composite
# ops would cost there.
CORI_PHASE1 = ComponentCosts(W=3.0, R=3.7, A_cas=3.8, A_fao=3.9,
                             am_rt=5.0, handler=0.15, name="cori-aries")

# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (as nvidia-smi prints
# them): the component medians of `python3 chip_smoke.py` phase 10 (seed
# 0; host time per op of one 65,536-op call at P = 64 that ends in a
# synchronize, on a window of 64 ranks x 786,432 words), fitted by
# `calibrate` as its `calibrated_costs` does, in the run of record that
# PERF.md section 6 names. All ranks share the one card, so a "remote" op
# is a routed phase of the port's engine on it; the fields phase 10 does
# not measure keep CORI_PHASE1's base values.
H100_SXM = ComponentCosts(W=0.04335676574707126, R=0.03415191650400079,
                          A_cas=0.035411773681784386,
                          A_fao=0.034770217895423866,
                          am_rt=0.040714141845681756, handler=0.0,
                          A_cas_put=0.037526107788017626,
                          A_cas_put_pub=0.035797607422175665,
                          A_fao_get=0.03347549438472916, name="h100-sxm")


class DSOp(enum.Enum):
    HT_INSERT = "hash_insert"
    HT_FIND = "hash_find"
    Q_PUSH = "queue_push"
    Q_POP = "queue_pop"
    TXN = "txn"


# Backend *arms* the adaptive layer chooses between per batch (core/adaptive
# .py). Each maps onto (Backend, fused?, progress_thread?) below.
ARMS = ("rdma", "rdma_fused", "am", "am_pt")


def attentiveness_delay(c: ComponentCosts, stats: OpStats) -> float:
    """Expected extra wait for an AM to be serviced (paper Fig. 6).

    Without a progress thread the request waits on average half the target's
    interspersed compute block; with one, service is immediate but every AM
    pays the progress/compute contention factor.
    """
    if stats.progress_thread:
        return c.am_rt * (c.pt_overhead - 1.0)
    return stats.target_busy_us / 2.0


def _p_scaled(c: ComponentCosts, stats: OpStats) -> ComponentCosts:
    """Apply the §9 P-dependence to a parameter set: one-sided wire terms
    grow with the occupancy-exchange width, am_rt with the reply fan-out.
    Returns `c` unchanged when P is unknown (stats.nranks == 0) or both
    slopes are zero, and zeroes the slopes on the result so the scaling is
    idempotent under predict()'s internal recursion."""
    p = int(stats.nranks)
    if p <= 1 or (c.exch_per_rank == 0.0 and c.fanout_per_rank == 0.0):
        return c
    wire = 1.0 + c.exch_per_rank * (p - 1)
    fan = 1.0 + c.fanout_per_rank * (p - 1)
    return replace(
        c,
        W=c.W * wire, R=c.R * wire,
        A_cas=c.A_cas * wire, A_fao=c.A_fao * wire,
        A_cas_put=None if c.A_cas_put is None else c.A_cas_put * wire,
        A_cas_put_pub=(None if c.A_cas_put_pub is None
                       else c.A_cas_put_pub * wire),
        A_fao_get=None if c.A_fao_get is None else c.A_fao_get * wire,
        am_rt=c.am_rt * fan,
        exch_per_rank=0.0, fanout_per_rank=0.0)


def _rpc_cost(c: ComponentCosts, stats: OpStats) -> float:
    # Skew serializes handler work at the hot owner, but the AM round trip
    # itself is amortized by aggregation — only the (small) handler term
    # scales, which is why AM wins skewed batches (DESIGN.md §4).
    return (c.am_rt + c.handler * max(1.0, stats.skew)
            + attentiveness_delay(c, stats))


def predict(op: DSOp, promise: Promise, backend: Backend,
            stats: Optional[OpStats] = None,
            params: ComponentCosts = CORI_PHASE1,
            fused: bool = False, coalesce: bool = False,
            cached: bool = False) -> float:
    """Best-case per-op latency (µs) — the paper's Tables II/III formulas.

    fused=True prices the fused-descriptor engine (DESIGN.md §2): the
    hash-table insert collapses to probes fused claim/write(/publish)
    phases and the C_RW find's lock+get fuse into one A_FAO_GET pair.

    coalesce=True prices sender-side combining (DESIGN.md §6) via the
    distinct-row factor rho = stats.dedup: only rho of the batch's rows
    cross the wire and land in the owner apply lanes, so (a) the per-op
    component terms amortize over 1/rho duplicate riders and (b) the hot
    owner's serialized lane sees skew*rho of the mean load instead of
    skew. Every op additionally pays the sender-side `combine` overhead.
    rho = 1 (all-distinct traffic) degrades to the uncoalesced formula
    plus the combine overhead — which is why the chooser only coalesces
    when the observed dedup ratio is < 1.

    cached=True prices the hot-bucket cache tier (DESIGN.md §8) on the
    one-sided find: every op pays the host-side `cache_lookup`, the hit
    fraction (stats.hit_rate) pays NOTHING else — a hit issues zero
    exchanges — and only the miss fraction pays the wire formula (over
    which the coalesce discount still applies, since the miss subset
    feeds the coalesced plan). hit_rate = 0 degrades to the uncached
    formula plus the lookup overhead, which is why the chooser only
    prices the cached arm when a cache is attached and warm."""
    s = stats or OpStats()
    c = _p_scaled(params, s)
    if backend == Backend.AUTO:
        raise ValueError("predict() needs a concrete backend; "
                         "use choose_backend() first")
    if cached:
        if not (op == DSOp.HT_FIND and promise == Promise.CR
                and backend == Backend.RDMA):
            raise ValueError("cached pricing only applies to the "
                             "one-sided CR find (DESIGN.md §8)")
        hr = min(1.0, max(0.0, float(s.hit_rate)))
        base = predict(op, promise, backend, s, c, fused=fused,
                       coalesce=coalesce, cached=False)
        return c.cache_lookup + (1.0 - hr) * base
    if op == DSOp.TXN:
        # DESIGN.md §11: one commit round is four dependent phases —
        # READ (version-stamped snapshot), LOCK (write-set CAS + read
        # probes), COMMIT (the grouped all-or-nothing apply), UNLOCK.
        # `ops_per_rank` is the ops-per-transaction k: the wire phases
        # amortize over the batch but the owner's serialized lane (and
        # the AM handler) walk all k rows, scaled by the hot-owner skew.
        k = max(1.0, float(s.ops_per_rank))
        if coalesce:
            # read gets and lock CASes dedup sender-side (§6); commit
            # rows never coalesce (each txn's rows are distinct by gid),
            # which the distinct-row recursion prices conservatively.
            rho = min(1.0, max(float(s.dedup), 1e-3))
            inner = predict(op, promise, backend,
                            replace(s, skew=max(1.0, s.skew * rho),
                                    dedup=1.0), c, fused=fused,
                            coalesce=False)
            return rho * inner + c.combine
        if backend == Backend.RPC:
            rt = c.am_rt + attentiveness_delay(c, s)
            return 4.0 * rt + c.handler * k * max(1.0, s.skew)
        txn_amo = c.amo_apply * max(1.0, s.skew)
        return c.R + 3.0 * (c.A_cas + k * txn_amo)
    if backend == Backend.RPC:
        if coalesce:
            rho = min(1.0, max(float(s.dedup), 1e-3))
            base = _rpc_cost(c, replace(s, skew=max(1.0, s.skew * rho)))
            return rho * base + (1.0 - rho) * c.handler + c.combine
        return _rpc_cost(c, s)

    probes = max(1.0, s.expected_probes)
    # Conflicting atomics funnel into one owner's serialized apply lane: a
    # batch with skew k makes the hot owner apply k× the mean load, so the
    # per-op owner-lane term scales with the skew (the Fig. 3
    # FAD-single-variable pathology, generalized to partial skew).
    if coalesce:
        # distinct-row factor: the hot lane only applies the distinct rows
        rho = min(1.0, max(float(s.dedup), 1e-3))
        base = predict(op, promise, backend,
                       replace(s, skew=max(1.0, s.skew * rho), dedup=1.0),
                       c, fused=fused, coalesce=False)
        return rho * base + c.combine
    amo = c.amo_apply * max(1.0, s.skew)
    if op == DSOp.HT_INSERT:
        if promise == Promise.CRW:      # (a) fully atomic: CAS + W + FAO
            if fused:                   # probes × (claim+write+publish)
                return probes * (c.fused_cas_put_pub() + amo)
            return probes * (c.A_cas + amo) + c.W + c.A_fao + amo
        if promise == Promise.CW:       # (b) phasal: CAS + W
            if fused:                   # probes × (claim+write)
                return probes * (c.fused_cas_put() + amo)
            return probes * (c.A_cas + amo) + c.W
    if op == DSOp.HT_FIND:
        if promise == Promise.CRW:      # (c) FAO + R + FAO (read lock/unlock)
            if fused:                   # lock+get fused, then unlock
                return (c.fused_fao_get() + amo) + (c.A_fao + amo)
            return (c.A_fao + amo) + c.R + (c.A_fao + amo)
        if promise == Promise.CR:       # (d) bare get
            return c.R
    cont = max(1.0, s.contention)
    if op == DSOp.Q_PUSH:
        if promise == Promise.CRW:      # FAO + W + persistent CAS
            return (c.A_fao + amo) + c.W + cont * (c.A_cas + amo)
        if promise == Promise.CW:       # FAO + W
            return (c.A_fao + amo) + c.W
        if promise == Promise.CL:
            return c.local
    if op == DSOp.Q_POP:
        if promise == Promise.CRW:
            return (c.A_fao + amo) + c.R + cont * (c.A_cas + amo)
        if promise == Promise.CR:
            return (c.A_fao + amo) + c.R
        if promise == Promise.CL:
            return c.local
    raise ValueError(f"no formula for {op} at promise {promise}")


def predict_checksum_push(stats: Optional[OpStats] = None,
                          params: ComponentCosts = CORI_PHASE1) -> float:
    """Checksum-queue C_RW push: the ready-pointer CAS is replaced by an
    in-payload checksum word verified by the reader — FAO + W only."""
    c = params
    return (c.A_fao + c.amo_apply) + c.W


def network_phases(op: DSOp, promise: Promise, backend: Backend,
                   fused: bool = False) -> int:
    """Dependent network phases (== chained collectives in the lowered HLO).

    This is the structural invariant the dry-run cross-checks: an RDMA C_RW
    insert must show 3 dependent op phases (5 exchanges) where the RPC one
    shows 1 (2 exchanges). With fused=True the fused engine's counts apply:
    the C_RW insert's claim+write+publish is ONE phase and the C_RW find is
    2 (fused lock+get, then unlock).
    """
    if backend == Backend.RPC:
        return 1
    table = {
        (DSOp.HT_INSERT, Promise.CRW): 3, (DSOp.HT_INSERT, Promise.CW): 2,
        (DSOp.HT_FIND, Promise.CRW): 3, (DSOp.HT_FIND, Promise.CR): 1,
        (DSOp.Q_PUSH, Promise.CRW): 3, (DSOp.Q_PUSH, Promise.CW): 2,
        (DSOp.Q_POP, Promise.CRW): 3, (DSOp.Q_POP, Promise.CR): 2,
        (DSOp.Q_PUSH, Promise.CL): 0, (DSOp.Q_POP, Promise.CL): 0,
        # §11 commit round: read -> lock -> commit -> unlock, each a
        # dependent op phase regardless of fusion (the commit descriptor
        # is already one grouped phase).
        (DSOp.TXN, Promise.CRW): 4,
    }
    fused_table = {
        (DSOp.HT_INSERT, Promise.CRW): 1, (DSOp.HT_INSERT, Promise.CW): 1,
        (DSOp.HT_FIND, Promise.CRW): 2,
    }
    if fused and (op, promise) in fused_table:
        return fused_table[(op, promise)]
    return table[(op, promise)]


# Exchanges per two-phase component op (request + reply) on the planned
# engine; the one-time plan-occupancy exchange is accounted separately.
PLAN_EXCHANGES = 1


def exchange_count(op: DSOp, promise: Promise, backend: Backend,
                   fused: bool = False, probes: int = 1) -> int:
    """All-to-all exchanges issued by `routing.exchange` per batch — what
    the roofline collective counter sees in the lowered HLO (excluding the
    one PLAN_EXCHANGES occupancy exchange when fused/planned).

    Unfused (route() per phase): a two-phase op costs 3 exchanges (request
    payload + request occupancy mask + reply) and a put costs 2. Planned:
    the occupancy mask was exchanged at plan time, so a two-phase op is 2
    (request + reply) and a put is 1 — hence C_RW find drops from 9 to 4
    per probe at the engine level, and from 6 to 4 in the paper's
    phase-pair accounting.
    """
    if backend == Backend.RPC:
        return 2 if fused else 3       # AM request (+mask) + reply
    two, put = (2, 1) if fused else (3, 2)
    # queue CRW counts assume one publish-CAS round (predict's cont=1
    # best case); both queue FAO phases (reserve + failure return) count.
    table = {
        (DSOp.HT_INSERT, Promise.CRW):
            probes * two if fused else probes * two + put + two,
        (DSOp.HT_INSERT, Promise.CW):
            probes * two if fused else probes * two + put,
        (DSOp.HT_FIND, Promise.CRW):
            probes * 2 * two if fused else probes * 3 * two,
        (DSOp.HT_FIND, Promise.CR): probes * two,
        (DSOp.Q_PUSH, Promise.CRW): two + two + put + two,
        (DSOp.Q_PUSH, Promise.CW): two + two + put,
        (DSOp.Q_POP, Promise.CRW): two + two + two + two,
        (DSOp.Q_POP, Promise.CR): two + two + two,
        (DSOp.Q_PUSH, Promise.CL): 0, (DSOp.Q_POP, Promise.CL): 0,
    }
    return table[(op, promise)]


def choose_backend(op: DSOp, promise: Promise,
                   stats: Optional[OpStats] = None,
                   params: ComponentCosts = CORI_PHASE1,
                   fused: bool = False) -> Backend:
    """The paper operationalized: pick the cheaper style for this workload.
    fused=True re-validates the choice against the fused/planned engine
    (the RDMA side gets cheaper; RPC is already one round trip)."""
    s = stats or OpStats()
    rdma = predict(op, promise, Backend.RDMA, s, params, fused=fused)
    rpc = predict(op, promise, Backend.RPC, s, params)
    return Backend.RDMA if rdma <= rpc else Backend.RPC


def arm_coalesces(op: DSOp, arm: str, dedup: float) -> bool:
    """Whether the engine actually runs `arm` with sender-side combining
    (DESIGN.md §6) for this op at this observed dedup ratio — the single
    rule shared by the pricer (predict_arm) and the executor
    (adaptive.decide), so arms are never scored with a discount the
    execution cannot realize:

    - the seed `rdma` arm never coalesces (it is the uncombined baseline);
    - queue ops never coalesce on the AM arms (a push handler is NOT
      idempotent across identical requests — each push must land) and
      the one-sided queue arms only combine their ticket FAOs;
    - everything else coalesces exactly when duplicates exist (dedup < 1).
    """
    if dedup >= 1.0 or arm == "rdma":
        return False
    if op in (DSOp.Q_PUSH, DSOp.Q_POP) and arm in ("am", "am_pt"):
        return False
    if op == DSOp.TXN and arm in ("am", "am_pt"):
        # the AM txn arm's commit dispatch carries per-txn rows that must
        # each land (like a queue push) — no bit-exact combine exists
        return False
    return True


def arm_caches(op: DSOp, promise: Promise, arm: str) -> bool:
    """Whether `arm` consults the hot-bucket cache (DESIGN.md §8) for this
    op — the single rule shared by the pricer (`predict_arm`) and the
    executor (adaptive.decide), mirroring `arm_coalesces`.

    Only the planned+fused one-sided find at the bare-read promise caches:
    CR is the only promise whose reply is a plain published record (CRW's
    read locks must hit the owner every time), and the seed `rdma` arm
    stays the uncombined, uncached baseline. The AM arms never cache —
    the handler round trip IS their aggregation story."""
    return (op == DSOp.HT_FIND and promise == Promise.CR
            and arm == "rdma_fused")


def _predict_arm_flat(op: DSOp, promise: Promise, arm: str, s: OpStats,
                      params: ComponentCosts) -> float:
    """Un-pipelined (lock-step) per-op latency of one arm — the sum of its
    origin- and owner-side components. `predict_arm` applies the §7 overlap
    interpolation on top of this."""
    co = arm_coalesces(op, arm, s.dedup)
    if arm == "rdma":
        base = predict(op, promise, Backend.RDMA, s, params, fused=False)
    elif arm == "rdma_fused":
        ca = s.hit_rate > 0.0 and arm_caches(op, promise, arm)
        base = predict(op, promise, Backend.RDMA, s, params, fused=True,
                       coalesce=co, cached=ca)
    elif arm == "am":
        base = predict(op, promise, Backend.RPC,
                       replace(s, progress_thread=False), params,
                       coalesce=co)
    elif arm == "am_pt":
        base = predict(op, promise, Backend.RPC,
                       replace(s, progress_thread=True), params,
                       coalesce=co)
    else:
        raise ValueError(f"unknown arm {arm!r}; expected one of {ARMS}")
    # §10 retry term: under per-attempt loss rate lr each op expects
    # lr/(1-lr) retransmissions of its smallest retryable unit — the AM
    # arms re-send a whole round trip, the one-sided arms one wire phase
    # (half a put) — plus the fixed retry_penalty bookkeeping. lr = 0
    # contributes exactly nothing, so every lossless prediction (and the
    # pinned orderings built on them) is bit-identical to the §9 model.
    lr = min(0.95, max(0.0, s.loss_rate))
    if lr > 0.0:
        retries = lr / (1.0 - lr)
        unit = params.am_rt if arm in ("am", "am_pt") else 0.5 * params.W
        base += retries * (params.retry_penalty + unit)
    # §11 abort term: a txn that fails optimistic validation re-runs the
    # WHOLE round on the same arm, so under abort probability ar each
    # batch expects ar/(1-ar) extra rounds of its full per-arm cost plus
    # the fixed retry_penalty bookkeeping per abort. Unlike wire loss the
    # retried unit is arm-symmetric (every arm replays read+lock+commit+
    # unlock), so contention scales arms multiplicatively and the chooser
    # ranks on their base costs — fed by AdaptiveEngine.abort_ewma, the
    # sixth online signal. ar = 0 contributes exactly nothing.
    ar = min(0.95, max(0.0, s.abort_rate))
    if ar > 0.0:
        rounds = ar / (1.0 - ar)
        base = base * (1.0 + rounds) + rounds * params.retry_penalty
    return base


def overlap_split(op: DSOp, promise: Promise, arm: str,
                  stats: Optional[OpStats] = None,
                  params: ComponentCosts = CORI_PHASE1
                  ) -> Tuple[float, float]:
    """Split one arm's flat cost into (origin_us, owner_us) — the two
    pipeline stages of DESIGN.md §7.

    origin_us — route/coalesce/plan construction and the send exchange:
    the work batch *k+1* performs while batch *k* is still applying.
    owner_us — everything attributable to target-side progress: the
    serialized `amo_apply` owner lane of the one-sided arms, and the
    handler compute plus the attentiveness delay of the AM arms. This is
    the share the pipeline hides behind the next batch's origin stage.

    Computed by differencing: owner_us = flat - flat|owner-terms-zeroed,
    so the split composes correctly with the skew and dedup factors
    (which scale both sides through `predict`). origin_us + owner_us ==
    the flat prediction exactly."""
    s = replace(stats or OpStats(), pipeline_depth=1)
    total = _predict_arm_flat(op, promise, arm, s, params)
    if arm in ("am", "am_pt"):
        wire_params = replace(params, handler=0.0, pt_overhead=1.0)
        wire_stats = replace(s, target_busy_us=0.0)
    else:
        wire_params = replace(params, amo_apply=0.0)
        wire_stats = s
    origin = _predict_arm_flat(op, promise, arm, wire_stats, wire_params)
    origin = min(origin, total)
    return origin, total - origin


# The engine (the JAX package's core/pipeline.py) is a TWO-stage pipeline:
# host staging (route/coalesce/plan on the Python thread) and device apply.
# Two in-flight windows already achieve all the overlap the structure
# admits; extra depth only lengthens the submission queue. The JAX package's CPU trajectory
# agrees — per-batch medians saturate at depth 2 and REGRESS at depth 4
# (~7% in BENCH_trajectory.json), the regression being host
# scheduling/retirement overhead for the extra queued windows.
PIPELINE_STAGES = 2


def predict_pipelined(op: DSOp, promise: Promise, arm: str,
                      stats: Optional[OpStats] = None,
                      params: ComponentCosts = CORI_PHASE1,
                      depth: Optional[int] = None) -> float:
    """Steady-state per-batch latency of one arm at pipeline depth d
    (DESIGN.md §7):

        T(d) = max(A, B) + min(A, B) / min(d, S)
                 + max(0, d - S) * pipe_depth_overhead,   S = PIPELINE_STAGES

    with (A, B) = `overlap_split` — a two-stage pipeline keeps d windows
    in flight, so the shorter stage hides behind the longer one except for
    the un-overlapped residue. d = 1 degenerates EXACTLY to the flat sum
    A + B (the synchronous engine). The overlap term SATURATES at
    S = PIPELINE_STAGES: the engine has two stages, so no overlap beyond
    double-buffering exists to win, and each extra queued window costs the
    measured per-depth `pipe_depth_overhead` (0 by default; calibrate()
    sets the slope fitted from the depth sweep). `depth` defaults to
    stats.pipeline_depth."""
    s = stats or OpStats()
    d = max(1, int(s.pipeline_depth if depth is None else depth))
    a, b = overlap_split(op, promise, arm, s, params)
    t = max(a, b) + min(a, b) / min(d, PIPELINE_STAGES)
    return t + max(0, d - PIPELINE_STAGES) * params.pipe_depth_overhead


# Depths the auto-depth chooser prices (DESIGN.md §9) — the same ladder the
# JAX package's depth-sweep bench measures. With PIPELINE_STAGES = 2 the model can only
# ever prefer 1 or 2 (depth 4 adds pipe_depth_overhead and no overlap), but
# keeping 4 in the ladder pins exactly that: the chooser must never pick it.
DEPTH_CANDIDATES = (1, 2, 4)


def choose_depth(op: DSOp, promise: Promise, arm: str,
                 stats: Optional[OpStats] = None,
                 params: ComponentCosts = CORI_PHASE1,
                 candidates: Tuple[int, ...] = DEPTH_CANDIDATES,
                 max_depth: Optional[int] = None) -> int:
    """Model-side pipeline-depth pick: argmin of `predict_pipelined` over
    the candidate ladder, tie-broken toward the SHALLOWEST depth (depth is
    never free — each extra window holds host memory and delays retirement,
    so equal predicted latency means take the smaller window count).

    An op whose owner-side share is zero (e.g. the bare CR find: no apply
    lane, no handler) predicts identical latency at every depth and stays
    at depth 1; owner-heavy ops (inserts with apply lanes, AM arms under
    poor attentiveness) flip to depth 2 as the hidden share grows. The
    online layer (`AdaptiveEngine.choose_depth`) overlays observed
    per-depth batch latency on top of this prior."""
    s = stats or OpStats()
    best_d, best_t = 1, float("inf")
    for d in sorted(set(int(x) for x in candidates)):
        if d < 1 or (max_depth is not None and d > max_depth):
            continue
        t = predict_pipelined(op, promise, arm, s, params, depth=d)
        if t < best_t - 1e-9:
            best_d, best_t = d, t
    return best_d


def predict_arm(op: DSOp, promise: Promise, arm: str,
                stats: Optional[OpStats] = None,
                params: ComponentCosts = CORI_PHASE1) -> float:
    """Per-op latency of one adaptive *arm* (see ARMS).

    `rdma` / `rdma_fused` are the seed and planned+fused one-sided engines;
    `am` / `am_pt` are aggregated active messages without / with a progress
    thread (the paper Fig. 6 "PT" curve). The AUTO chooser in
    core/adaptive.py calls this for every arm and takes the argmin.

    The observed dedup ratio (stats.dedup, the adaptive layer's third
    online signal) prices coalescing where the engine actually applies it
    (`arm_coalesces`): duplicate traffic discounts the fused/AM arms with
    the distinct-row factor — the seed `rdma` arm never coalesces and
    keeps the plain formula.

    stats.pipeline_depth > 1 (the pipelined engine, DESIGN.md §7) applies
    the overlap term via `predict_pipelined`: the arm's owner-side share
    (serialized apply lane, or handler + attentiveness for the AM arms)
    overlaps the next batch's route+send, so owner-heavy arms — notably AM
    under poor attentiveness — are discounted by exactly the latency the
    pipeline hides, which is how the chooser learns to prefer AM arms once
    overlap hides their handler latency."""
    s = stats or OpStats()
    if int(s.pipeline_depth) > 1:
        return predict_pipelined(op, promise, arm, s, params)
    return _predict_arm_flat(op, promise, arm, s, params)


def calibrate(measured: Dict[str, float],
              base: ComponentCosts = CORI_PHASE1) -> ComponentCosts:
    """Build a parameter set from measured component latencies (µs).

    Keys: any of W, R, A_cas, A_fao, am_rt, handler, local, amo_apply,
    A_cas_put, A_cas_put_pub, A_fao_get, combine, cache_lookup,
    pipe_depth_overhead, retry_penalty.
    """
    fields = {k: v for k, v in measured.items()
              if k in ComponentCosts.__dataclass_fields__}
    return replace(base, name="calibrated", **fields)


# ---------------------------------------------------------------------------
# Model-layer choosers: the same move-data-vs-move-compute decision applied
# to the serving stack.
# ---------------------------------------------------------------------------
def moe_dispatch_bytes(backend: Backend, *, tokens_per_rank: int,
                       d_model: int, expert_bytes_per_rank: int,
                       dtype_bytes: int = 2) -> int:
    """Bytes crossing the network per rank per layer for MoE dispatch.

    RPC  = ship activations to expert owners and back (2 x token bytes);
    RDMA = pull the expert weight blocks to the data owner (1 x weights).
    """
    if backend == Backend.RPC:
        return 2 * tokens_per_rank * d_model * dtype_bytes
    return expert_bytes_per_rank


def choose_moe_backend(**kw) -> Backend:
    rpc = moe_dispatch_bytes(Backend.RPC, **kw)
    rdma = moe_dispatch_bytes(Backend.RDMA, **kw)
    return Backend.RPC if rpc <= rdma else Backend.RDMA


def attention_gather_bytes(backend: Backend, *, kv_bytes_per_shard: int,
                           q_heads: int, head_dim: int, shards: int,
                           dtype_bytes: int = 2) -> int:
    """Distributed decode attention: RDMA = gather remote KV pages to the
    query owner; RPC = ship the query, compute partial attention at each KV
    shard, return (m, l, o) flash stats, bytes independent of cache length.
    """
    if backend == Backend.RDMA:
        return (shards - 1) * kv_bytes_per_shard
    stats_bytes = q_heads * (head_dim + 2) * 4  # o + (m, l) in f32
    query_bytes = q_heads * head_dim * dtype_bytes
    return (shards - 1) * (query_bytes + stats_bytes)


def choose_attention_backend(**kw) -> Backend:
    rdma = attention_gather_bytes(Backend.RDMA, **kw)
    rpc = attention_gather_bytes(Backend.RPC, **kw)
    return Backend.RDMA if rdma <= rpc else Backend.RPC
