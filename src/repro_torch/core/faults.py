"""Deterministic fault injection + exactly-once delivery (port of
`repro.core.faults`, DESIGN.md §10).

The paper's caveat about RPC-style ops is that they "can suffer from lack
of attentiveness from the remote side". This module makes failure a
deterministically injectable axis of the P-rank engine:

  FaultPlan     a seeded per-(phase, origin, row, attempt) fault
                schedule: dropped rows, duplicated (ack-lost) rows,
                delayed rows, and slow/dead owners (AM service that
                stops for k rounds or forever). Any chaos run is exactly
                reproducible from its seed.
  RetryPolicy   the origin-side retry budget: capped exponential
                backoff, bounded attempts, a deadline in simulated
                dispatch rounds.
  DedupIndex    the receiver half of exactly-once delivery: per
                (owner <- origin) channel sequence numbers, a watermark
                of the highest contiguously-admitted seq plus an
                out-of-order set, so replayed rows apply exactly once.
  RemoteTimeout the typed failure `Handle.result(timeout=)` raises
                instead of hanging on a dead owner.

Delivery model (the §10 invariant): faults and retries play out INSIDE
one exchange phase, like NIC link-level retransmission. The engine's
(src_rank, slot) serialization order is fixed by the routing plan, not
by delivery order, so once every surviving row has been applied exactly
once the phase's visible result is bit-identical to the fault-free phase.

Fault scoping: wire faults (drop/dup/delay) hit every arm; owner faults
(dead_owners, queue stall) hit only the AM lane: a dead host CPU stops
servicing handlers while its NIC keeps answering one-sided ops, and the
chooser quarantines such an owner by re-routing its traffic one-sided
(core/adaptive.py).

The schedule is numpy, drawn in the JAX package's order, so the same
calls with the same seed give the same drops, duplicates, delays, retries
and keep masks in both packages. Each hook copies `dst` (and `valid`) to
the host: a device read per phase while a plan is in scope. A probe or
CAS-round loop is a `lax.while_loop` / `fori_loop` in the JAX package,
whose body is traced once: its plane draws each body phase once, at the
loop's entry, and that draw holds for every round. The port's loops are
eager, so they run under `loop_scope`, which makes the same draws on
entry and replays them in each round; whole streams then give the same
plane stats, owner health and quarantines in both packages.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from .types import to_host

__all__ = ["RemoteTimeout", "RetryPolicy", "DedupIndex", "FaultPlan",
           "fault_scope", "active_plane", "loop_scope", "in_traced_loop"]


class RemoteTimeout(TimeoutError):
    """A remote owner failed to service a request before its deadline."""


@dataclass(frozen=True)
class RetryPolicy:
    """Origin-side retry budget.

    max_attempts bounds wire retransmits per row inside one phase (at the
    default 16, a row survives drop_rate=0.5 with probability 1 - 2^-16);
    base_delay/max_delay shape the capped exponential backoff charged to
    the plane's clock; deadline bounds how many simulated dispatch rounds
    `Handle.result()` waits on a stalled deferred-AM queue before raising
    RemoteTimeout.
    """
    max_attempts: int = 16
    base_delay: float = 1.0
    max_delay: float = 64.0
    deadline: int = 64

    def delay(self, attempt: int) -> float:
        """Backoff charged before retransmit #attempt (1-based)."""
        return float(min(self.base_delay * (2.0 ** max(0, attempt - 1)),
                         self.max_delay))


# ---------------------------------------------------------------------------
# Deterministic fault stream: splitmix-style hash of
# (seed, phase, origin, row, attempt, salt) -> uniform [0, 1).
# ---------------------------------------------------------------------------
_K = tuple(np.uint64(k) for k in (
    0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB,
    0xD6E8FEB86659FD93, 0xFF51AFD7ED558CCD, 0xC2B2AE3D27D4EB4F))
_SALT_DROP, _SALT_ACK, _SALT_DELAY = 1, 2, 3


def _uniform(seed: int, salt: int, phase: int, attempt: int,
             P: int, n: int) -> np.ndarray:
    """(P, n) uniforms, a pure function of every argument."""
    with np.errstate(over="ignore"):
        o = (np.arange(P, dtype=np.uint64) + np.uint64(1))[:, None]
        r = (np.arange(n, dtype=np.uint64) + np.uint64(1))[None, :]
        h = (np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _K[0]
             ^ np.uint64(phase) * _K[1]
             ^ np.uint64(attempt + 1) * _K[2]
             ^ np.uint64(salt) * _K[3])
        h = h ^ (o * _K[4]) ^ (r * _K[5])
        h = (h ^ (h >> np.uint64(30))) * _K[1]
        h = (h ^ (h >> np.uint64(27))) * _K[2]
        h = h ^ (h >> np.uint64(31))
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _fold_keep(keep: np.ndarray, dst: torch.Tensor, valid):
    """valid & keep as a bool tensor on dst's device (keep alone when
    valid is None)."""
    keep_t = torch.as_tensor(keep, device=dst.device)
    if valid is None:
        return keep_t
    return valid & keep_t


# ---------------------------------------------------------------------------
# Receiver-side exactly-once filter
# ---------------------------------------------------------------------------
class DedupIndex:
    """Per-channel sequence numbers + watermark dedup.

    Origins stamp every request row with a monotonically increasing seq on
    its (owner <- origin) channel (`assign`); owners admit each tag at most
    once (`admit`): seq <= watermark, or present in the out-of-order set,
    is a duplicate. The watermark advances over contiguous runs so the set
    only holds genuinely reordered tags. The tags ride out of band of the
    payload words, so the wire layouts are unchanged.
    """

    def __init__(self, nranks: int):
        self.nranks = nranks
        self.next_seq = np.zeros((nranks, nranks), dtype=np.int64)
        self.watermark = np.full((nranks, nranks), -1, dtype=np.int64)
        self.out_of_order: Dict[Tuple[int, int], Set[int]] = {}
        self.admitted = 0
        self.dup_filtered = 0

    def grow(self, nranks: int) -> None:
        """Widen the channel matrices to `nranks` ranks, keeping every
        existing seq and watermark (new ranks open channels at seq 0)."""
        if nranks <= self.nranks:
            return
        ns = np.zeros((nranks, nranks), dtype=np.int64)
        ns[:self.nranks, :self.nranks] = self.next_seq
        wm = np.full((nranks, nranks), -1, dtype=np.int64)
        wm[:self.nranks, :self.nranks] = self.watermark
        self.next_seq, self.watermark = ns, wm
        self.nranks = nranks

    def assign(self, dst: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Stamp each active row with its channel's next seq.

        Returns (P, n) int64 seqs (-1 on inactive rows)."""
        P, n = active.shape
        seqs = np.full((P, n), -1, dtype=np.int64)
        for o in range(P):
            for c in np.nonzero(active[o])[0]:
                w = int(dst[o, c])
                if not 0 <= w < self.nranks:
                    continue  # out-of-range dst: routing drops it anyway
                seqs[o, c] = self.next_seq[w, o]
                self.next_seq[w, o] += 1
        return seqs

    def admit(self, owner: int, origin: int, seq: int) -> bool:
        """Admit one (origin, seq) tag at `owner`; False = duplicate."""
        if seq <= self.watermark[owner, origin]:
            self.dup_filtered += 1
            return False
        oo = self.out_of_order.setdefault((owner, origin), set())
        if seq in oo:
            self.dup_filtered += 1
            return False
        oo.add(seq)
        w = int(self.watermark[owner, origin])
        while w + 1 in oo:
            w += 1
            oo.discard(w)
        self.watermark[owner, origin] = w
        self.admitted += 1
        return True


# ---------------------------------------------------------------------------
# The fault plane
# ---------------------------------------------------------------------------
class FaultPlan:
    """Seeded fault schedule + the plane's runtime state.

    Config:
      seed          master seed: every fault is a pure function of
                    (seed, phase, origin, row, attempt, salt).
      drop_rate     P(request row lost on the wire) per attempt.
      dup_rate      P(ack lost) per delivered attempt: the row was applied
                    but the origin retransmits it, and the owner's
                    DedupIndex filters the redelivery.
      delay_rate /  fraction of rows delayed, and for how many attempts.
      delay_rounds
      dead_owners   {rank: wake_round or None}: AM service at `rank` stops
                    until the plane's round clock reaches wake_round (None
                    = forever). One-sided phases are NOT affected.
      stall_rounds/ the deferred-AM dispatch queue refuses to drain for its
      stall_forever first stall_rounds service opportunities, or forever
                    (`Pipeline._force` then raises RemoteTimeout).
      retry         RetryPolicy for origin retransmits.

    The round clock advances once per AM service opportunity (every
    `AMEngine.dispatch` and every `drain_dispatch_queue` call), so "stalls
    for k rounds" means "misses its next k chances to serve".
    """

    def __init__(self, nranks: int, seed: int = 0, drop_rate: float = 0.0,
                 dup_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_rounds: int = 0,
                 dead_owners: Optional[Dict[int, Optional[int]]] = None,
                 stall_rounds: int = 0, stall_forever: bool = False,
                 retry: RetryPolicy = RetryPolicy()):
        self.nranks = int(nranks)
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.dup_rate = float(dup_rate)
        self.delay_rate = float(delay_rate)
        self.delay_rounds = int(delay_rounds)
        self.dead_owners = dict(dead_owners or {})
        self.stall_rounds = int(stall_rounds)
        self.stall_forever = bool(stall_forever)
        self.retry = retry
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self) -> None:
        self.phase_idx = 0
        self.round = 0
        self.dedup = DedupIndex(self.nranks)
        self.owner_rows = np.zeros(self.nranks, dtype=np.int64)
        self.owner_retries = np.zeros(self.nranks, dtype=np.int64)
        self.owner_unserviced = np.zeros(self.nranks, dtype=np.int64)
        self.backoff_total = 0.0
        self.dropped = 0
        self.exhausted = 0
        self.stall_hits = 0
        self._last_unserviced: Optional[np.ndarray] = None
        self._loop: Optional[list] = None   # [draws, next] in a loop_scope

    def _accommodate(self, dst_np: np.ndarray) -> None:
        """Widen per-rank state when a phase addresses more ranks than the
        plan was built for."""
        hi = int(dst_np.shape[0])
        if dst_np.size:
            hi = max(hi, int(dst_np.max()) + 1)
        if hi <= self.nranks:
            return
        pad = hi - self.nranks
        self.owner_rows = np.pad(self.owner_rows, (0, pad))
        self.owner_retries = np.pad(self.owner_retries, (0, pad))
        self.owner_unserviced = np.pad(self.owner_unserviced, (0, pad))
        self.dedup.grow(hi)
        self.nranks = hi

    @property
    def _wire_faults(self) -> bool:
        return bool(self.drop_rate or self.dup_rate
                    or (self.delay_rate and self.delay_rounds))

    def owner_stalled(self, rank: int) -> bool:
        """Is `rank`'s AM service down at the current round?"""
        if rank not in self.dead_owners:
            return False
        wake = self.dead_owners[rank]
        return wake is None or self.round < wake

    def queue_stalled(self) -> bool:
        return self.stall_forever or self.round < self.stall_rounds

    def queue_dead(self) -> bool:
        return self.stall_forever

    def tick(self) -> None:
        """One AM service opportunity passes."""
        self.round += 1

    def wait_for_service(self) -> bool:
        """Advance one round; True if the deferred queue may now drain,
        False if it is permanently stalled (no point waiting)."""
        if self.stall_forever:
            return False
        self.tick()
        return not self.queue_stalled()

    # -- the attempt-loop simulation ---------------------------------------
    def _simulate(self, phase: int, dst: np.ndarray,
                  active: np.ndarray) -> np.ndarray:
        """Play one phase's delivery to completion: per attempt, drop rows
        (wire loss / delay), admit arrivals through the dedup filter, then
        lose acks (dup_rate) so origins retransmit already applied rows.
        Returns `applied`: rows the owner admitted exactly once. A row
        applied but never acked by max_attempts still counts applied; a
        never-applied exhausted row is masked out and counted."""
        P, n = active.shape
        pol = self.retry
        seqs = self.dedup.assign(dst, active)
        clip = np.clip(dst, 0, self.nranks - 1)
        delayed_for = np.zeros((P, n), dtype=np.int64)
        if self.delay_rate and self.delay_rounds:
            u = _uniform(self.seed, _SALT_DELAY, phase, 0, P, n)
            delayed_for = np.where(u < self.delay_rate,
                                   self.delay_rounds, 0)
        applied = np.zeros((P, n), dtype=bool)
        pending = active.copy()
        for a in range(pol.max_attempts):
            if not pending.any():
                break
            if a > 0:
                self.backoff_total += pol.delay(a) * int(pending.sum())
                np.add.at(self.owner_retries, clip[pending], 1)
            u_drop = _uniform(self.seed, _SALT_DROP, phase, a, P, n)
            lost = (u_drop < self.drop_rate) | (a < delayed_for)
            arrive = pending & ~lost
            self.dropped += int((pending & lost).sum())
            # the owner applies each arrival at most once, in (origin, col)
            # order; serialization itself is the routing plan's
            for o, c in np.argwhere(arrive):
                if self.dedup.admit(int(dst[o, c]), int(o),
                                    int(seqs[o, c])):
                    applied[o, c] = True
            u_ack = _uniform(self.seed, _SALT_ACK, phase, a, P, n)
            pending = pending & ~(arrive & (u_ack >= self.dup_rate))
        self.exhausted += int((pending & ~applied).sum())
        return applied

    # -- engine hooks -------------------------------------------------------
    def inject_phase(self, role: str, dst, valid):
        """Window-lane hook (one-sided phases): fold wire faults into the
        phase's effective valid mask. Returns `valid` unchanged (the same
        object) when every row survives. Inside a `loop_scope` it replays
        the scope's draws instead, in the body's order."""
        if self._loop is not None:
            draws, i = self._loop
            self._loop[1] = i + 1
            keep = draws[i % len(draws)]
            if keep is None:
                return valid
            return keep if valid is None else valid & keep
        phase = self.phase_idx
        self.phase_idx += 1
        if not self._wire_faults:
            return valid
        dst_np = to_host(dst)
        if dst_np.ndim != 2:
            return valid
        self._accommodate(dst_np)
        P, n = dst_np.shape
        valid_np = to_host(valid)
        active = (np.ones((P, n), dtype=bool) if valid_np is None
                  else valid_np.astype(bool))
        np.add.at(self.owner_rows,
                  np.clip(dst_np, 0, self.nranks - 1)[active], 1)
        applied = self._simulate(phase, dst_np, active)
        keep = applied | ~active
        if keep.all():
            return valid
        return _fold_keep(keep, dst, valid)

    def inject_am(self, dst, valid):
        """AM-lane hook, applied pre-coalescing at op-row granularity: rows
        addressed to a stalled/dead owner are recorded unserviced and
        masked (callers re-route them, see AdaptiveEngine); the rest go
        through the same wire retransmit+dedup simulation as one-sided
        phases."""
        phase = self.phase_idx
        self.phase_idx += 1
        dst_np = to_host(dst)
        if dst_np.ndim != 2:
            return valid
        self._accommodate(dst_np)
        P, n = dst_np.shape
        valid_np = to_host(valid)
        active = (np.ones((P, n), dtype=bool) if valid_np is None
                  else valid_np.astype(bool))
        clip = np.clip(dst_np, 0, self.nranks - 1)
        dead = np.zeros(self.nranks, dtype=bool)
        for r in self.dead_owners:
            dead[r] = self.owner_stalled(r)
        unserviced = active & dead[clip] & (dst_np == clip)
        np.add.at(self.owner_rows, clip[active], 1)
        np.add.at(self.owner_unserviced, clip[unserviced], 1)
        live = active & ~unserviced
        applied = (self._simulate(phase, dst_np, live)
                   if self._wire_faults else live)
        self._last_unserviced = unserviced if unserviced.any() else None
        keep = applied | ~active
        if keep.all():
            return valid
        return _fold_keep(keep, dst, valid)

    # -- consumers ----------------------------------------------------------
    def take_unserviced(self) -> Optional[np.ndarray]:
        """(P, n) bool mask of the last AM dispatch's rows that hit a
        dead/stalled owner (None if none), consumed by the adaptive layer
        to fail those rows over to the one-sided lane."""
        u = self._last_unserviced
        self._last_unserviced = None
        return u

    def take_owner_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-owner fault pressure accumulated since the last take:
        {rank: {"rows", "retries", "unserviced"}}, the feed for the
        chooser's health EWMA. Resets on read."""
        out: Dict[int, Dict[str, int]] = {}
        for r in range(self.nranks):
            rows = int(self.owner_rows[r])
            ret = int(self.owner_retries[r])
            uns = int(self.owner_unserviced[r])
            if rows or ret or uns:
                out[r] = {"rows": rows, "retries": ret, "unserviced": uns}
        self.owner_rows[:] = 0
        self.owner_retries[:] = 0
        self.owner_unserviced[:] = 0
        return out

    def stats(self) -> Dict[str, float]:
        """Cumulative plane counters (not reset by take_owner_stats)."""
        return {"phases": self.phase_idx, "round": self.round,
                "dropped": self.dropped,
                "dup_filtered": self.dedup.dup_filtered,
                "admitted": self.dedup.admitted,
                "exhausted": self.exhausted,
                "stall_hits": self.stall_hits,
                "backoff_total": self.backoff_total}


# ---------------------------------------------------------------------------
# Scope plumbing (the window.decision_scope idiom)
# ---------------------------------------------------------------------------
_CURRENT_PLAN: Optional[FaultPlan] = None
_LOOP_DEPTH = 0     # open loop_scopes


@contextlib.contextmanager
def fault_scope(plan: Optional[FaultPlan]):
    """Activate `plan` for the dynamic extent: window phases, AM
    dispatch/drain, and pipeline forcing all consult `active_plane()`."""
    global _CURRENT_PLAN
    prev = _CURRENT_PLAN
    _CURRENT_PLAN = plan
    try:
        yield plan
    finally:
        _CURRENT_PLAN = prev


def active_plane() -> Optional[FaultPlan]:
    """The FaultPlan in scope, or None (the fault-free engine)."""
    return _CURRENT_PLAN


@contextlib.contextmanager
def loop_scope(dst: torch.Tensor, roles: Tuple[str, ...]):
    """Run a loop of one-sided phases (a probe loop, CAS rounds) as the
    JAX package's plane sees it. There the loop is traced once, its mask
    symbolic: each phase of the body is simulated once, at the loop's
    entry, with every row of `dst` taken as active, and the keep mask it
    draws holds in every round. So here one draw per role in `roles` (the
    body's phases, in order) is made on entry, and each round's hooks
    replay them, whatever the trip count.

    With or without a plan, the scope also marks the loop as one that JAX
    traces (`in_traced_loop`): there its offsets are tracers, so a publish
    issued inside it never reaches the hot-bucket cache."""
    global _LOOP_DEPTH
    plane = _CURRENT_PLAN
    _LOOP_DEPTH += 1
    try:
        if plane is None:
            yield
            return
        draws = [plane.inject_phase(role, dst, None) for role in roles]
        prev, plane._loop = plane._loop, [draws, 0]
        try:
            yield
        finally:
            plane._loop = prev
    finally:
        _LOOP_DEPTH -= 1


def in_traced_loop() -> bool:
    """True inside a `loop_scope`: a loop the JAX package traces."""
    return _LOOP_DEPTH > 0
