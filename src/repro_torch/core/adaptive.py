"""Adaptive hybrid backend: cost-model-driven RDMA/RPC arm selection per
batch (port of `repro.core.adaptive`, DESIGN.md §4).

The paper's punchline is not that RDMA always wins: the analytical model
*orders* the implementations, "allowing us to choose the best
implementation" (§VI). Every data-structure op batch (hash-table
insert/find, queue push/pop) picks one of four *arms*

    rdma        per-component one-sided engine (fused=False / planned=False)
    rdma_fused  planned + fused-descriptor one-sided engine
    am          aggregated active messages
    am_pt       active messages serviced by a progress thread (Fig. 6 "PT")

by `costmodel.predict_arm` over calibrated ComponentCosts plus the online
signals the engine keeps itself: an EWMA of measured latency per (op, arm)
(`observe`; measured numbers replace the model's once they exist), the
batch skew and dedup ratio (`batch_skew`, `batch_dedup`, counted on the
batch's own device), a per-depth EWMA, the write fraction, the cache hit
rate, owner health with quarantine, and the loss and txn-abort EWMAs.

Every choice is recorded as a `Decision`; the RDMA arms run inside
`window.decision_scope` and the AM arms thread the record into
`AMEngine.dispatch`. On a CUDA structure each arm launches the same
kernels as the fixed backend it names (B1/B2 on the one-sided arms, B3/B4
on the AM arms); an arm that fails raises.

With a hot-bucket cache attached (core/cache.py), every insert bumps the
probe-window versions of its keys before any arm runs and runs inside
`window.cache_scope`; CR finds on the fused one-sided arm consult the
cache while the stream is not write-heavy, priced with the hit-rate EWMA.

Under a fault plane (core/faults.py) the AM arms fail the rows of a dead
or stalled owner over to the one-sided lane, and the plane's per-owner
pressure feeds the health EWMA and the quarantine. With a pipeline
(core/pipeline.py) `auto_depth` lets the chooser set the window count.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import costmodel as cm
from . import faults as flt
from . import hashtable as ht_mod
from . import queue as q_mod
from . import window as win_mod
from .costmodel import ARMS, ComponentCosts, DSOp
from .types import OpStats, Promise, as_i32, as_mask, to_device


@dataclass(frozen=True)
class Decision:
    """One per-batch backend choice, the record shared with
    `AMEngine.dispatch` and `window.decision_scope`."""

    op: DSOp
    promise: Promise
    arm: str                      # one of costmodel.ARMS
    skew: float                   # batch owner-load skew (1.0 if unknown)
    scores: Dict[str, float]      # per-arm score (µs/op) the choice used
    source: str                   # "model" | "ewma" | "mixed" | "forced" | ...
    batch_ops: int                # valid ops in the batch
    dedup: float = 1.0            # distinct-row fraction (1.0 if unknown)
    coalesce: bool = False        # the executed arm ran with coalescing
    cached: bool = False          # the executed arm consulted the cache
    hit_rate: float = 0.0         # hit-rate EWMA the scores were priced with
    depth: int = 1                # pipeline depth the batch runs at
    quarantined: bool = False     # an AM choice re-routed one-sided because
                                  # the batch targets a quarantined owner


def _flat(x, valid) -> torch.Tensor:
    """`x` (tensor or array) as a 1-D tensor on its own device, restricted
    to the rows where `valid` (when given) is True."""
    x = torch.as_tensor(x)
    if valid is not None:
        x = x[torch.as_tensor(valid, dtype=torch.bool, device=x.device)]
    return x.reshape(-1)


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


def batch_dedup(keys, valid=None) -> float:
    """Distinct-row fraction of a batch: unique keys / total rows (the
    third online signal, DESIGN.md §6). Counted on the keys' device; the
    same float as the JAX package's numpy version."""
    flat = _flat(keys, valid)
    if flat.numel() == 0:
        return 1.0
    return float(torch.unique(flat).numel() / flat.numel())


def batch_skew(dst, nranks: int, valid=None) -> float:
    """Max owner load / mean owner load over all `nranks` owners: 1.0 =
    uniform, `nranks` = one hot owner. A bincount on the destinations'
    device, one scalar read back; the statistic `routing.plan_skew`
    derives from a RoutePlan, without the plan's occupancy exchange."""
    flat = _flat(dst, valid)
    if flat.numel() == 0:
        return 1.0
    counts = torch.bincount(flat.to(torch.int64), minlength=nranks)
    return float(int(counts.max()) * nranks / flat.numel())


def _sync(out) -> None:
    """Wait for the device that the first tensor of `out` lives on."""
    dev = next(x.device for x in out if isinstance(x, torch.Tensor))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _failover_rows(uns: np.ndarray, valid, device):
    """(m, rv) for the failover of unserviced AM rows: the plane's host
    mask on the batch's device, and the rows to re-run one-sided (m, or
    valid & m)."""
    m = to_device(uns, torch.bool, device)
    return m, (m if valid is None else valid & m)


class AdaptiveEngine:
    """Per-batch arm chooser + data-structure front-end wrappers.

    am_engine:  AMEngine servicing the `am` / `am_pt` arms (those arms are
                disabled when absent). Handlers are registered against the
                first structure each wrapper sees (one AMEngine per
                structure, as in `am.AMEngine`).
    params:     ComponentCosts prior for the model scores (default
                `costmodel.H100_SXM`); `calibrate()` replaces it.
    alpha:      EWMA step for observed per-op latencies.
    policy:     "cost" (argmin score) or "round_robin" (cycle the arms).
    measure:    time each executed batch (one device synchronize a batch)
                and feed the EWMA.
    explore_every: when > 0, a "cost" decision probes the runner-up arm
                instead of the winner whenever the runner-up's EWMA has not
                been refreshed for this many decisions of the same op (a
                clear loser, score > 2x the winner's, at a quarter of that
                rate).
    hysteresis: relative margin under which a decision sticks with the
                op's incumbent arm when both its and the winner's scores
                are measured EWMAs (model scores never engage it).
    cache:      optional core/cache.BucketCache, opt-in and never made
                here: the default engines are shared across tables, and a
                cache is coherent for exactly one table, whose writes go
                through this engine's `ht_insert`. CR finds on the fused
                one-sided arm consult it; the observed hit rate feeds
                `hit_ewma` (priced via OpStats.hit_rate), and a
                write-fraction EWMA suspends cache reads, not
                invalidation, in write-heavy streams.
    """

    #: write-fraction EWMA above which cache reads are suspended
    WRITE_HEAVY = 0.5

    def __init__(self, nranks: int, am_engine=None,
                 params: ComponentCosts = cm.H100_SXM,
                 alpha: float = 0.25, arms: Optional[Tuple[str, ...]] = None,
                 policy: str = "cost", measure: bool = False,
                 explore_every: int = 0, cache=None,
                 hysteresis: float = 0.10):
        if arms is None:
            arms = ARMS if am_engine is not None else ("rdma", "rdma_fused")
        for a in arms:
            if a not in ARMS:
                raise ValueError(f"unknown arm {a!r}")
            if a in ("am", "am_pt") and am_engine is None:
                raise ValueError(f"arm {a!r} needs an am_engine")
        if policy not in ("cost", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self.nranks = nranks
        self.am_engine = am_engine
        self.params = params
        self.alpha = alpha
        self.arms = tuple(arms)
        self.policy = policy
        self.measure = measure
        self.explore_every = explore_every
        self.hysteresis = hysteresis
        self.force_arm: Optional[str] = None
        self.cache = cache
        self.hit_ewma = 0.0    # observed cache hit rate
        self.write_ewma = 0.0  # observed write fraction of the op stream
        # per-owner fault pressure in [0, 1] (0 = healthy); owners at or
        # past QUARANTINE_ON are quarantined: their AM traffic re-routes
        # to the one-sided arms, which need no owner attention
        self.health: Dict[int, float] = {}
        self.quarantined: set = set()
        self.loss_ewma = 0.0   # retransmits / transmissions
        self.abort_ewma = 0.0  # txn aborts / attempts
        self.ewma: Dict[Tuple[DSOp, str], float] = {}
        self.depth_ewma: Dict[Tuple[DSOp, int], float] = {}
        # bounded ring: the default AUTO front doors log every batch here
        self.log: collections.deque = collections.deque(maxlen=4096)
        self.last_decision: Optional[Decision] = None
        self._rr = 0
        self._op_count: Dict[DSOp, int] = {}          # decisions per op
        self._seen: Dict[Tuple[DSOp, str], int] = {}  # last observe tick
        self._last_arm: Dict[DSOp, str] = {}          # hysteresis incumbent

    # -- signals ------------------------------------------------------------
    def calibrate(self, measured: Dict[str, float]) -> ComponentCosts:
        """Replace the model prior with measured component latencies."""
        self.params = cm.calibrate(measured, base=self.params)
        return self.params

    #: a single observation may exceed the arm's EWMA by at most this
    #: factor before it is clipped, so one spike of a shared host does not
    #: flip the argmin for the batches the EWMA needs to recover
    OBSERVE_CLIP = 4.0

    def observe(self, decision: Decision, us_per_op: float) -> None:
        """EWMA-update the measured latency of (op, arm)."""
        key = (decision.op, decision.arm)
        prev = self.ewma.get(key)
        if prev is not None:
            us_per_op = min(us_per_op, self.OBSERVE_CLIP * prev)
        self.ewma[key] = (us_per_op if prev is None
                          else prev + self.alpha * (us_per_op - prev))
        self._seen[key] = self._op_count.get(decision.op, 0)
        if decision.depth > 1 or (decision.op, decision.depth) \
                in self.depth_ewma:
            self.observe_depth(decision.op, decision.depth, us_per_op)

    def observe_depth(self, op: DSOp, depth: int, us_per_op: float) -> None:
        """EWMA-update the measured per-op latency of (op, depth), which
        `choose_depth` prefers over the predict_pipelined prior."""
        key = (op, max(1, int(depth)))
        prev = self.depth_ewma.get(key)
        self.depth_ewma[key] = (us_per_op if prev is None
                                else prev + self.alpha * (us_per_op - prev))

    def attach_cache(self, cache) -> None:
        """Attach a hot-bucket cache. One cache per table: coherence holds
        only for writes issued through this engine."""
        self.cache = cache

    def cache_reads_on(self) -> bool:
        """Whether CR finds consult the cache: one is attached, enabled,
        and the stream is not write-heavy."""
        return (self.cache is not None and self.cache.enabled
                and self.write_ewma < self.WRITE_HEAVY)

    def _observe_rw(self, is_write: bool) -> None:
        self.write_ewma += self.alpha * (float(is_write) - self.write_ewma)

    # -- owner health (DESIGN.md §10) ---------------------------------------
    #: health EWMA at/above which an owner is quarantined; released once
    #: it decays below half of it
    QUARANTINE_ON = 0.5

    def quarantine(self, rank: int, pressure: float = 1.0) -> None:
        """Mark `rank` unhealthy (health raised to >= `pressure`); at
        QUARANTINE_ON or above its AM traffic re-routes one-sided."""
        self.health[rank] = max(self.health.get(rank, 0.0), float(pressure))
        if self.health[rank] >= self.QUARANTINE_ON:
            self.quarantined.add(rank)

    def ingest_fault_stats(self, plane) -> None:
        """Fold a fault plane's per-owner counters (`take_owner_stats()`:
        rank -> {"rows", "unserviced", "retries"}) into the health EWMA,
        pressure = (unserviced + 0.25 * retries) / rows clamped to [0, 1],
        and refresh the loss EWMA (retransmits over transmissions)."""
        taken = plane.take_owner_stats()
        if not taken:
            return
        for r, st in taken.items():
            rows = max(1, st["rows"])
            pressure = min(1.0, (st["unserviced"] + 0.25 * st["retries"])
                           / rows)
            prev = self.health.get(r)
            h = (pressure if prev is None
                 else prev + self.alpha * (pressure - prev))
            self.health[r] = h
            if h >= self.QUARANTINE_ON:
                self.quarantined.add(r)
            elif h < self.QUARANTINE_ON / 2:
                self.quarantined.discard(r)
        rows = sum(st["rows"] for st in taken.values())
        ret = sum(st["retries"] for st in taken.values())
        lr = ret / max(1, rows + ret)
        self.loss_ewma = (lr if self.loss_ewma == 0.0
                          else self.loss_ewma
                          + self.alpha * (lr - self.loss_ewma))

    def ingest_txn_stats(self, commits: int, aborts: int) -> None:
        """Fold one transaction run's commit/abort counts into the abort
        EWMA (seeded by the first observation)."""
        attempts = commits + aborts
        if attempts <= 0:
            return
        ar = aborts / attempts
        self.abort_ewma = (ar if self.abort_ewma == 0.0
                           else self.abort_ewma
                           + self.alpha * (ar - self.abort_ewma))

    def quarantine_from_monitor(self, classes: Dict[int, str],
                                ranks_per_host: int = 1) -> None:
        """Bridge straggler verdicts (host -> "dead" / "replace" / "slow"
        / healthy) into the health signal: a bad host quarantines its
        ranks [h * ranks_per_host, (h + 1) * ranks_per_host); a healthy
        verdict decays them toward release."""
        severity = {"dead": 1.0, "replace": 0.9, "slow": 0.6}
        for host, cls in classes.items():
            for r in range(host * ranks_per_host,
                           (host + 1) * ranks_per_host):
                if not 0 <= r < self.nranks:
                    continue
                if cls in severity:
                    self.quarantine(r, severity[cls])
                elif r in self.health:
                    h = (1.0 - self.alpha) * self.health[r]
                    self.health[r] = h
                    if h < self.QUARANTINE_ON / 2:
                        self.quarantined.discard(r)

    def _after_am(self) -> Optional[np.ndarray]:
        """Post-execution fault bookkeeping: with a fault plane in scope,
        ingest its per-owner pressure and return the last AM dispatch's
        unserviced-row mask (host numpy; None when everything was
        serviced) so the wrapper can fail those rows over to the one-sided
        lane."""
        plane = flt.active_plane()
        if plane is None:
            return None
        uns = plane.take_unserviced()
        self.ingest_fault_stats(plane)
        return uns

    def _fault_stats(self, s: OpStats) -> OpStats:
        """Fold the loss and abort EWMAs into OpStats.loss_rate and
        abort_rate (pre-set values win)."""
        if self.loss_ewma > 0.0 and s.loss_rate == 0.0:
            s = replace(s, loss_rate=min(0.95, self.loss_ewma))
        if self.abort_ewma > 0.0 and s.abort_rate == 0.0:
            s = replace(s, abort_rate=min(0.95, self.abort_ewma))
        return s

    # -- decision -----------------------------------------------------------
    def scores(self, op: DSOp, promise: Promise,
               stats: Optional[OpStats] = None,
               skew: Optional[float] = None) -> Tuple[Dict[str, float], str]:
        """Per-arm score in µs/op: the measured EWMA when one exists for
        (op, arm), else the cost model's prediction. Returns (scores,
        source). `skew`, when given, overrides stats.skew for the model."""
        stats = self._fault_stats(stats or OpStats())
        ew = self.ewma
        out = {}
        for arm in self.arms:
            v = ew.get((op, arm))
            if v is None:
                break
            out[arm] = v
        else:
            return out, "ewma"     # every arm measured: no model at all
        s = stats
        if skew is not None and skew != s.skew:
            s = replace(s, skew=skew)
        if s.nranks == 0:
            s = replace(s, nranks=self.nranks)
        out, used = {}, set()
        for arm in self.arms:
            v = ew.get((op, arm))
            if v is not None:
                out[arm] = v
                used.add("ewma")
            else:
                out[arm] = cm.predict_arm(op, promise, arm, s, self.params)
                used.add("model")
        return out, ("mixed" if len(used) > 1 else used.pop())

    def peek_arm(self, op: DSOp, promise: Promise,
                 stats: Optional[OpStats] = None) -> str:
        """The arm `decide` would pick, without logging a Decision,
        advancing the round-robin cursor or consuming an exploration."""
        if self.force_arm is not None:
            return self.force_arm
        if self.policy == "round_robin":
            return self.arms[self._rr % len(self.arms)]
        scores, _ = self.scores(op, promise, stats)
        return self._cost_choice(op, scores)[0]

    # tie-break toward the cheaper-at-runtime engine: the planned + fused
    # arm dominates the seed arm at equal predicted cost
    _ARM_RANK = {"rdma_fused": 0, "am": 1, "am_pt": 2, "rdma": 3}

    def _cost_choice(self, op: DSOp, scores: Dict[str, float]):
        """(arm, ranked arms) under the "cost" policy: argmin score, except
        that an incumbent within `hysteresis` of the winner stays when
        both scores are measured EWMAs."""
        ranked = sorted(scores, key=lambda a: (scores[a], self._ARM_RANK[a]))
        arm = ranked[0]
        last = self._last_arm.get(op)
        if (last is not None and last != arm and last in scores
                and (op, last) in self.ewma and (op, arm) in self.ewma
                and scores[last] <= scores[arm] * (1.0 + self.hysteresis)):
            arm = last
        return arm, ranked

    def choose_depth(self, op: DSOp, promise: Promise,
                     stats: Optional[OpStats] = None,
                     arm: Optional[str] = None,
                     max_depth: Optional[int] = None) -> int:
        """Pipeline depth for this (op, promise, stats): the argmin over
        `costmodel.DEPTH_CANDIDATES` of `predict_pipelined` for the arm
        `peek_arm` would run (or `arm`), with every measured (op, depth)
        EWMA replacing the model's number and the unmeasured depths scaled
        by the mean measured/model ratio; ties go to the shallowest."""
        s = stats or OpStats()
        if s.nranks == 0:
            s = replace(s, nranks=self.nranks)
        if arm is None:
            arm = self.peek_arm(op, promise, s)
        cands = [d for d in sorted(set(int(x) for x in cm.DEPTH_CANDIDATES))
                 if d >= 1 and (max_depth is None or d <= max_depth)]
        model = {d: cm.predict_pipelined(op, promise, arm, s, self.params,
                                         depth=d) for d in cands}
        obs = {d: self.depth_ewma[(op, d)] for d in cands
               if (op, d) in self.depth_ewma}
        factor = 1.0
        if obs:
            ratios = [obs[d] / model[d] for d in obs if model[d] > 0.0]
            if ratios:
                factor = sum(ratios) / len(ratios)
        best_d, best_t = 1, float("inf")
        for d in cands:
            t = obs.get(d, model[d] * factor)
            if t < best_t - 1e-9:
                best_d, best_t = d, t
        return best_d

    def auto_depth(self, pipe, op: DSOp, promise: Promise,
                   stats: Optional[OpStats] = None) -> OpStats:
        """Submit-time hook of the async front doors: when `pipe` opted
        into auto-depth, pick the window count with `choose_depth`,
        retarget the pipeline (`Pipeline.set_depth`, capped at its
        constructor depth) and return the stats priced at that depth, so
        the stage-time Decision records it. A fixed-depth pipeline passes
        through untouched."""
        s = stats or OpStats()
        if not getattr(pipe, "auto_depth", False):
            return s
        d = self.choose_depth(op, promise, s, max_depth=pipe.max_depth)
        pipe.set_depth(d)
        return replace(s, pipeline_depth=d)

    def decide(self, op: DSOp, promise: Promise, dst=None, valid=None,
               stats: Optional[OpStats] = None,
               nops: Optional[int] = None,
               owners: Optional[Tuple[int, ...]] = None) -> Decision:
        """Choose the arm for one batch. `dst` (P, n) feeds the skew
        statistic (read only while some arm still needs a model price and
        `stats.skew` is unset); `stats` carries the other workload
        signals; `owners`, when given, is the static owner set the batch
        targets (the hosted queue's host), used for the quarantine test
        without reading `dst`."""
        s = stats or OpStats()
        skew = s.skew
        ewma_complete = all((op, a) in self.ewma for a in self.arms)
        if not ewma_complete and dst is not None and skew == 1.0:
            skew = batch_skew(dst, self.nranks, valid)
        dedup = s.dedup
        if nops is None:
            if valid is not None:
                nops = int(torch.as_tensor(valid).sum())
            elif dst is not None:
                nops = _numel(dst)
            else:
                nops = 0
        scores, source = self.scores(op, promise, s, skew=skew)
        tick = self._op_count.get(op, 0) + 1
        self._op_count[op] = tick
        if self.force_arm is not None:
            arm, source = self.force_arm, "forced"
        elif self.policy == "round_robin":
            arm = self.arms[self._rr % len(self.arms)]
            self._rr += 1
            source = "round_robin"
        else:
            arm, ranked = self._cost_choice(op, scores)
            self._last_arm[op] = arm
            if self.explore_every > 0 and len(ranked) > 1:
                runner = ranked[1] if ranked[0] == arm else ranked[0]
                need = self.explore_every
                if scores[runner] > 2.0 * scores[arm]:
                    need *= 4     # a clear loser: refresh it less often
                if tick - self._seen.get((op, runner), 0) >= need:
                    arm, source = runner, "explore"
                    # the probe counts as seen now, so exploration stays
                    # bounded even when nothing observes its latency
                    self._seen[(op, runner)] = tick
        # an AM arm needs the owner's attention, which a quarantined owner
        # does not give: re-route to the cheapest one-sided arm (forced
        # arms are exempt)
        quarantined_flag = False
        if (self.quarantined and source != "forced"
                and arm in ("am", "am_pt")):
            if owners is not None:
                hit = any(int(r) in self.quarantined for r in owners)
            elif dst is not None:
                flat = _flat(dst, valid)
                bad = torch.tensor(sorted(self.quarantined),
                                   dtype=flat.dtype, device=flat.device)
                hit = bool(torch.isin(flat, bad).any())
            else:
                hit = False
            if hit:
                cands = [a for a in scores if a not in ("am", "am_pt")]
                if cands:
                    arm = min(cands,
                              key=lambda a: (scores[a], self._ARM_RANK[a]))
                    source = "quarantine"
                    quarantined_flag = True
                    self._last_arm[op] = arm
        dec = Decision(op=op, promise=promise, arm=arm, skew=skew,
                       scores=scores, source=source, batch_ops=nops,
                       dedup=dedup,
                       coalesce=cm.arm_coalesces(op, arm, dedup),
                       cached=(self.cache_reads_on()
                               and cm.arm_caches(op, promise, arm)),
                       hit_rate=s.hit_rate,
                       depth=max(1, int(s.pipeline_depth)),
                       quarantined=quarantined_flag)
        self.log.append(dec)
        self.last_decision = dec
        return dec

    # -- execution helpers --------------------------------------------------
    def _timed(self, dec: Decision, fn):
        """Run fn(); when measuring, wait for its output's device and feed
        the EWMA. am_pt charges the progress-thread contention factor on
        top of the measured dispatch (Fig. 6 "PT")."""
        if not (self.measure and dec.batch_ops):
            return fn()
        t0 = time.perf_counter()
        out = fn()
        _sync(out)
        us = (time.perf_counter() - t0) * 1e6 / dec.batch_ops
        if dec.arm == "am_pt":
            us *= self.params.pt_overhead
        self.observe(dec, us)
        return out

    def _host_stats(self, stats: Optional[OpStats]) -> OpStats:
        """Stats for a hosted (single-owner) structure: every op targets
        the host rank, so the skew is `nranks` by construction."""
        s = stats or OpStats()
        return s if s.skew != 1.0 else replace(s, skew=float(self.nranks))

    def _need_am(self, name: str, register):
        eng = self.am_engine
        if eng is None:
            raise ValueError("an AM arm needs an am_engine")
        if not eng.has_handler(name):
            register(eng)
        return eng

    # -- data-structure wrappers -------------------------------------------
    def _ht_stats(self, keys, valid, stats: Optional[OpStats]) -> OpStats:
        """Hash-table batch stats with the observed dedup ratio folded in;
        pre-set `stats.dedup` to skip the count."""
        s = stats or OpStats()
        if s.dedup == 1.0:
            s = replace(s, dedup=batch_dedup(keys, valid))
        return s

    def ht_insert(self, ht, keys, vals, promise: Promise = Promise.CRW,
                  valid=None, max_probes: int = 8,
                  stats: Optional[OpStats] = None):
        """Adaptive hash-table insert: returns (table', ok, probes).
        Duplicate-key batches (dedup < 1) run the fused/AM arms with
        sender-side coalescing on. With a cache attached, every insert, on
        any arm, bumps the probe-window versions of its keys before it
        runs, so no stale record is served after this call returns (keys
        given on the host are read there, without waiting for the card)."""
        dev = ht.win.data.device
        keys_in, valid_in = keys, valid
        keys, vals = as_i32(keys, dev), as_i32(vals, dev)
        if valid is not None:
            valid = as_mask(valid, keys.shape, dev)
        dst, _ = ht_mod._place(ht, keys)
        dec = self.decide(DSOp.HT_INSERT, promise, dst, valid,
                          self._ht_stats(keys, valid, stats))
        self._observe_rw(is_write=True)
        if self.cache is not None:
            # authoritative invalidation: versions bump before any write
            # lands, so a racing deferred fill tick-mismatches and drops
            self.cache.on_insert_keys(keys_in, valid_in, max_probes)
        if dec.arm in ("am", "am_pt"):
            eng = self._need_am(
                "ht_insert",
                lambda e: ht_mod.build_am_handlers(ht, e,
                                                   max_probes=max_probes))
            ht2, ok, probes = self._timed(dec, lambda: ht_mod.insert_rpc(
                ht, eng, keys, vals, valid=valid, decision=dec,
                coalesce=dec.coalesce))
            uns = self._after_am()
            if uns is not None:
                # rows whose owner never serviced the AM (dead/stalled)
                # land through the one-sided lane: the target NIC stays
                # live when its host CPU does not. A dead owner's rows
                # move together, so its apply order is kept; coalesce
                # rides along so duplicate keys collapse to one record, as
                # the AM insert-or-assign would have applied them
                m, rv = _failover_rows(uns, valid, dev)
                with win_mod.decision_scope(dec), \
                        win_mod.cache_scope(self.cache):
                    ht2, ok2, pr2 = ht_mod.insert_rdma(
                        ht2, keys, vals, promise=promise, valid=rv,
                        max_probes=max_probes, fused=True,
                        coalesce=dec.coalesce)
                ok = torch.where(m, ok2, ok)
                probes = torch.where(m, pr2, probes)
            return ht2, ok, probes

        def run():
            with win_mod.decision_scope(dec), \
                    win_mod.cache_scope(self.cache):
                return ht_mod.insert_rdma(
                    ht, keys, vals, promise=promise, valid=valid,
                    max_probes=max_probes, fused=dec.arm == "rdma_fused",
                    coalesce=dec.coalesce)
        out = self._timed(dec, run)
        self._after_am()  # ingest wire-retry pressure from the phases
        return out

    def ht_find(self, ht, keys, promise: Promise = Promise.CR,
                valid=None, max_probes: int = 8,
                stats: Optional[OpStats] = None, max_stale: int = 0):
        """Adaptive hash-table find: returns (table', found, vals).

        With a cache attached and reads on (`cache_reads_on`), the
        hit-rate EWMA is folded into the stats so the chooser prices the
        cached fused arm with its discount, the executed CR fused find
        consults the cache, and the batch's observed hit rate refreshes
        the EWMA. max_stale: the cached arm's bounded-staleness tolerance
        (0 = exact reads); wire reads are always authoritative."""
        dev = ht.win.data.device
        keys_in, valid_in = keys, valid
        keys = as_i32(keys, dev)
        if valid is not None:
            valid = as_mask(valid, keys.shape, dev)
        dst, _ = ht_mod._place(ht, keys)
        s = self._ht_stats(keys, valid, stats)
        if self.cache_reads_on() and promise == Promise.CR \
                and s.hit_rate == 0.0:
            s = replace(s, hit_rate=self.hit_ewma)
        dec = self.decide(DSOp.HT_FIND, promise, dst, valid, s)
        self._observe_rw(is_write=False)
        if dec.arm in ("am", "am_pt"):
            eng = self._need_am(
                "ht_find",
                lambda e: ht_mod.build_am_handlers(ht, e,
                                                   max_probes=max_probes))
            found, vals = self._timed(dec, lambda: ht_mod.find_rpc(
                ht, eng, keys, valid=valid, decision=dec,
                coalesce=dec.coalesce))
            uns = self._after_am()
            if uns is not None:
                # unserviced finds re-read one-sided (reply words of
                # undelivered ops are garbage by contract, so the merge
                # overwrites exactly those rows)
                m, rv = _failover_rows(uns, valid, dev)
                with win_mod.decision_scope(dec):
                    _, f2, v2 = ht_mod.find_rdma(
                        ht, keys, promise=promise, valid=rv,
                        max_probes=max_probes, fused=True)
                found = torch.where(m, f2, found)
                vals = torch.where(m[..., None], v2, vals)
            return ht, found, vals

        cached = dec.cached

        def run():
            with win_mod.decision_scope(dec):
                # the cache reads the keys where the caller keeps them
                return ht_mod.find_rdma(
                    ht, keys_in if cached else keys, promise=promise,
                    valid=valid_in if cached else valid,
                    max_probes=max_probes, fused=dec.arm == "rdma_fused",
                    coalesce=dec.coalesce,
                    cache=self.cache if cached else None,
                    max_stale=max_stale)
        out = self._timed(dec, run)
        self._after_am()
        if cached and self.cache.last_hit_rate is not None:
            self.hit_ewma += self.alpha * (self.cache.last_hit_rate
                                           - self.hit_ewma)
        return out

    def q_push(self, q, vals, promise: Promise = Promise.CRW, valid=None,
               max_cas_rounds: int = 8, stats: Optional[OpStats] = None):
        """Adaptive queue push: returns (queue', pushed). The queue's
        `rdma_fused` arm is the planned engine (one RoutePlan for every
        component phase; the hosted queue has no compound descriptors)."""
        dev = q.win.data.device
        vals = as_i32(vals, dev)
        P, n, _ = vals.shape
        if valid is not None:
            valid = as_mask(valid, (P, n), dev)
        dec = self.decide(DSOp.Q_PUSH, promise, valid=valid,
                          stats=self._host_stats(stats),
                          nops=P * n if valid is None else None,
                          owners=(q.host,))
        if dec.arm in ("am", "am_pt"):
            eng = self._need_am(
                "q_push", lambda e: q_mod.build_am_handlers(q, e))
            q2, ok = self._timed(dec, lambda: q_mod.push_rpc(
                q, eng, vals, valid=valid, decision=dec))
            uns = self._after_am()
            if uns is not None:
                # the queue lives on ONE rank, so a dead host leaves the
                # whole batch unserviced and the re-run is a full
                # one-sided push, in the order its reservations hand out
                m, rv = _failover_rows(uns, valid, dev)
                with win_mod.decision_scope(dec):
                    q2, ok2 = q_mod.push_rdma(
                        q2, vals, promise=promise, valid=rv,
                        max_cas_rounds=max_cas_rounds, planned=True)
                ok = torch.where(m, ok2, ok)
            return q2, ok

        def run():
            with win_mod.decision_scope(dec):
                return q_mod.push_rdma(
                    q, vals, promise=promise, valid=valid,
                    max_cas_rounds=max_cas_rounds,
                    planned=dec.arm == "rdma_fused",
                    coalesce=dec.coalesce)
        out = self._timed(dec, run)
        self._after_am()
        return out

    def q_pop(self, q, n: int, promise: Promise = Promise.CR, valid=None,
              max_cas_rounds: int = 8, stats: Optional[OpStats] = None):
        """Adaptive queue pop: returns (queue', got, vals)."""
        dev = q.win.data.device
        if valid is not None:
            valid = as_mask(valid, (q.nranks, n), dev)
        dec = self.decide(DSOp.Q_POP, promise, valid=valid,
                          stats=self._host_stats(stats),
                          nops=q.nranks * n if valid is None else None,
                          owners=(q.host,))
        if dec.arm in ("am", "am_pt"):
            eng = self._need_am(
                "q_pop", lambda e: q_mod.build_am_handlers(q, e))
            q2, got, pvals = self._timed(dec, lambda: q_mod.pop_rpc(
                q, eng, n, valid=valid, decision=dec))
            uns = self._after_am()
            if uns is not None:
                # unserviced pops consumed nothing: run them again
                # one-sided against the updated queue
                m, rv = _failover_rows(uns, valid, dev)
                with win_mod.decision_scope(dec):
                    q2, g2, v2 = q_mod.pop_rdma(
                        q2, n, promise=promise, valid=rv,
                        max_cas_rounds=max_cas_rounds, planned=True)
                got = torch.where(m, g2, got)
                pvals = torch.where(m[..., None], v2, pvals)
            return q2, got, pvals

        def run():
            with win_mod.decision_scope(dec):
                return q_mod.pop_rdma(
                    q, n, promise=promise, valid=valid,
                    max_cas_rounds=max_cas_rounds,
                    planned=dec.arm == "rdma_fused",
                    coalesce=dec.coalesce)
        out = self._timed(dec, run)
        self._after_am()
        return out


# ---------------------------------------------------------------------------
# Default engines for the `backend="auto"` front doors, cached so the EWMA
# state and the decision log persist across calls that pass no explicit
# AdaptiveEngine: hung off the AMEngine when there is one (same lifetime),
# else one per nranks.
# ---------------------------------------------------------------------------
_DEFAULT: Dict[int, AdaptiveEngine] = {}


def default_engine(nranks: int, am_engine=None) -> AdaptiveEngine:
    if am_engine is not None:
        eng = getattr(am_engine, "_default_adaptive", None)
        if eng is None or eng.nranks != nranks:
            eng = AdaptiveEngine(nranks, am_engine=am_engine)
            am_engine._default_adaptive = eng
        return eng
    eng = _DEFAULT.get(nranks)
    if eng is None:
        eng = AdaptiveEngine(nranks)
        _DEFAULT[nranks] = eng
    return eng
