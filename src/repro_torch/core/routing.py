"""Owner-routing engine (port of `repro.core.routing`): bucket a batch of
ops by destination rank and exchange the buckets across ranks.

This is the *one network phase* primitive out of which both backends are
built: an RDMA component op is one routed phase (plus one reply phase when
it fetches something); an RPC dispatch is one routed request phase, a local
handler, and one routed reply phase.

Every participant ("virtual rank") owns row `r` of a `(P, ...)` tensor. On
one card the exchange is the transpose of the `(P_src, P_dst, ...)`
buffer, exactly as in the JAX package on one device. Where JAX vmaps a
per-origin function over the P axis, the port runs it on the leading batch
dimension directly.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import intops

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Sharding hook: an identity seam (the JAX launch layer pins the P axis to
# mesh axes through it; a sharded port will do the same with NCCL).
# ---------------------------------------------------------------------------
_SHARD_HOOK: Callable[[Tensor, str], Tensor] = lambda x, role: x


def set_sharding_hook(fn: Optional[Callable[[Tensor, str], Tensor]]):
    global _SHARD_HOOK
    _SHARD_HOOK = fn if fn is not None else (lambda x, role: x)


@contextlib.contextmanager
def sharding_hook(fn):
    global _SHARD_HOOK
    prev = _SHARD_HOOK
    _SHARD_HOOK = fn
    try:
        yield
    finally:
        _SHARD_HOOK = prev


def _hint(x: Tensor, role: str) -> Tensor:
    return _SHARD_HOOK(x, role)


def _rows(x: Tensor) -> Tensor:
    """(B, 1) row index for advanced indexing along dim 1."""
    return torch.arange(x.shape[0], device=x.device)[:, None]


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x[b, idx[b, i], ...] for x (B, n, ...) and idx (B, k)."""
    return x[_rows(idx), idx]


def _scatter_rows(idx: Tensor, src: Tensor) -> Tensor:
    """Inverse permutation: out[b, idx[b, i]] = src[b, i]."""
    out = torch.zeros_like(src)
    out[_rows(idx), idx] = src
    return out


def _prefix_max(x: Tensor) -> Tensor:
    return torch.cummax(x, dim=1).values


def _suffix_min(x: Tensor) -> Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


# ---------------------------------------------------------------------------
# Binning: per-origin scatter of ops into per-destination capacity slots.
# ---------------------------------------------------------------------------
@dataclass
class Binned:
    """Result of binning each origin's op batch by destination rank.

    buf:      (P, nranks, cap, W) payload words routed to each destination
    mask:     (P, nranks, cap)    slot occupancy
    op_slot:  (P, n)              slot index assigned to each original op
    op_ok:    (P, n)              op was delivered (not dropped by capacity)
    dropped:  (P,)                ops dropped (capacity overflow)
    """

    buf: Optional[Tensor]
    mask: Tensor
    op_slot: Tensor
    op_ok: Tensor
    dropped: Tensor


def _scatter_slots(dst: Tensor, slot: Tensor, keep: Tensor, pay: Tensor,
                   nranks: int, cap: int) -> Tensor:
    """buf[b, dst, slot] = pay for kept rows, as JAX's per-origin
    `.at[dst, slot].set(mode="drop")`: a negative rank wraps once (-1 is
    rank nranks-1) and is dropped if still negative, and where two kept rows
    of one origin land on one slot (a wrapped rank meeting the rank it
    wraps to) the later row wins. Dropped rows land in one spare row that
    is cut off (no host sync)."""
    B, n = dst.shape
    size = B * nranks * cap
    d = dst.to(torch.int64)
    d = torch.where(d < 0, d + nranks, d)
    flat = (_rows(dst) * nranks + d) * cap + slot
    flat = torch.where(keep & (d >= 0), flat, size).reshape(-1)
    order = torch.arange(B * n, dtype=torch.int32, device=dst.device)
    last = torch.full((size + 1,), -1, dtype=torch.int32, device=dst.device)
    last.scatter_reduce_(0, flat, order, "amax")
    flat = torch.where(last[flat] == order, flat, size)
    W = pay.shape[2:]
    out = pay.new_zeros((size + 1,) + W)
    out[flat] = pay.reshape((-1,) + W)
    return out[:size].reshape((B, nranks, cap) + W)


def bin_by_dest(dst: Tensor, payload: Optional[Tensor], nranks: int,
                cap: int, valid: Optional[Tensor] = None) -> Binned:
    """Bucket `n` ops per origin by destination rank.

    dst:     (P, n) int32 destination rank per op; a negative rank is
             sorted as itself and delivered to its wrapped rank, as in JAX
    payload: (P, n, W) payload words per op, or None for occupancy only
    cap:     per-destination slot capacity. cap >= n is always lossless.
    """
    B, n = dst.shape
    if valid is None:
        valid = torch.ones_like(dst, dtype=torch.bool)
    # invalid ops route to the sentinel rank nranks and are dropped
    dst_eff = torch.where(valid, dst, nranks).to(torch.int32)
    order = torch.argsort(dst_eff, dim=1, stable=True)
    dst_sorted = torch.gather(dst_eff, 1, order).contiguous()
    group_start = torch.searchsorted(dst_sorted, dst_sorted, side="left")
    pos_sorted = torch.arange(n, device=dst.device) - group_start
    ok_sorted = (pos_sorted < cap) & (dst_sorted < nranks)
    buf = None
    if payload is not None:
        buf = _scatter_slots(dst_sorted, pos_sorted, ok_sorted,
                             _gather_rows(payload, order), nranks, cap)
    mask = _scatter_slots(dst_sorted, pos_sorted, ok_sorted, ok_sorted,
                          nranks, cap)
    op_slot = _scatter_rows(order, pos_sorted.to(torch.int32))
    op_ok = _scatter_rows(order, ok_sorted)
    dropped = (valid.sum(1) - ok_sorted.sum(1)).to(torch.int32)
    return Binned(buf=buf, mask=mask, op_slot=op_slot, op_ok=op_ok,
                  dropped=dropped)


# ---------------------------------------------------------------------------
# Exchange: the network phase. (P_src, P_dst, ...) -> (P_dst, P_src, ...)
# ---------------------------------------------------------------------------
def exchange(x: Tensor, role: str = "exchange") -> Tensor:
    """Transpose the (src, dst) leading axes: each rank receives the buckets
    addressed to it. On one card this is a transpose, materialized as the
    phase's one copy of the buffer."""
    x = _hint(x, role + "_pre")
    out = x.transpose(0, 1).contiguous()
    return _hint(out, role + "_post")


@dataclass
class Routed:
    """A request batch delivered to owners.

    at_owner: (P_owner, P_src, cap, W) payloads as seen by each owner
    mask:     (P_owner, P_src, cap)
    op_slot:  (P_src, n) slot index of each original op
    op_ok:    (P_src, n)
    dropped:  (P_src,)
    """

    at_owner: Tensor
    mask: Tensor
    op_slot: Tensor
    op_ok: Tensor
    dropped: Tensor


@dataclass
class RoutePlan:
    """A reusable (dst, slot) assignment for a batch of ops.

    dst_eff: (P, n)  destination per op, invalid ops -> sentinel `nranks`
    op_slot: (P, n)  slot within the destination bucket (may be >= cap for
                     capacity-dropped ops)
    op_ok:   (P, n)  op was delivered (valid, in-capacity)
    mask:    (P_owner, P_src, cap) owner-side occupancy, exchanged ONCE at
             plan time; reused phases exchange only payload words
    dropped: (P,)    per-origin capacity drops
    cap:     per-destination slot capacity
    """

    dst_eff: Tensor
    op_slot: Tensor
    op_ok: Tensor
    mask: Tensor
    dropped: Tensor
    cap: int

    @property
    def nranks(self) -> int:
        return self.dst_eff.shape[0]


def make_plan(dst: Tensor, valid: Optional[Tensor] = None,
              cap: Optional[int] = None, role: str = "plan") -> RoutePlan:
    """Compute the routing assignment for a batch (ONE stable argsort) and
    exchange the occupancy mask (ONE exchange). Payload-only phases are
    then issued against the plan with `route_with_plan`; the binning is
    `bin_by_dest` itself, so plan slots equal route()'s by construction."""
    nranks, n = dst.shape
    cap = n if cap is None else cap
    if valid is None:
        valid = torch.ones_like(dst, dtype=torch.bool)
    binned = bin_by_dest(dst, None, nranks, cap, valid)
    dst_eff = torch.where(valid, dst, nranks).to(torch.int32)
    mask_at_owner = exchange(binned.mask, role + "_mask")
    return RoutePlan(dst_eff=dst_eff, op_slot=binned.op_slot,
                     op_ok=binned.op_ok, mask=mask_at_owner,
                     dropped=binned.dropped, cap=cap)


def make_plan_np(dst, valid=None, cap: Optional[int] = None,
                 role: str = "plan", device="cuda") -> RoutePlan:
    """Host-side (numpy) mirror of `make_plan`: the same slot assignment,
    computed on the Python thread; the occupancy mask still crosses as ONE
    `exchange` on `device`."""
    dst = np.asarray(dst)
    nranks, n = dst.shape
    cap = n if cap is None else cap
    valid = (np.ones(dst.shape, dtype=bool) if valid is None
             else np.asarray(valid).astype(bool))
    dst_eff = np.where(valid, dst, nranks).astype(np.int32)
    op_slot = np.zeros((nranks, n), np.int32)
    op_ok = np.zeros((nranks, n), bool)
    mask = np.zeros((nranks, nranks, cap), bool)
    dropped = np.zeros((nranks,), np.int32)
    for r in range(nranks):
        order = np.argsort(dst_eff[r], kind="stable")
        dst_s = dst_eff[r][order]
        group_start = np.searchsorted(dst_s, dst_s, side="left")
        pos = (np.arange(n) - group_start).astype(np.int32)
        ok = (pos < cap) & (dst_s < nranks)
        mask[r][dst_s[ok], pos[ok]] = True
        op_slot[r][order] = pos
        op_ok[r][order] = ok
        dropped[r] = int(valid[r].sum()) - int(ok.sum())
    mask_at_owner = exchange(torch.as_tensor(mask, device=device),
                             role + "_mask")
    return RoutePlan(dst_eff=torch.as_tensor(dst_eff, device=device),
                     op_slot=torch.as_tensor(op_slot, device=device),
                     op_ok=torch.as_tensor(op_ok, device=device),
                     mask=mask_at_owner,
                     dropped=torch.as_tensor(dropped, device=device),
                     cap=cap)


def owner_loads(plan: RoutePlan) -> Tensor:
    """Delivered ops per owner rank, from the plan's occupancy mask: the
    (P,) int32 histogram behind the adaptive layer's skew statistic, on
    the plan's device."""
    return plan.mask.sum(dim=(1, 2)).to(torch.int32)


def plan_skew(plan: RoutePlan) -> Tensor:
    """Batch skew statistic as a float32 scalar tensor: max owner load /
    mean owner load over all P owners (1.0 uniform, P one hot owner).
    `adaptive.batch_skew` computes the same statistic from `dst` without
    the plan's occupancy exchange."""
    loads = owner_loads(plan).to(torch.float32)
    total = torch.clamp(loads.sum(), min=1.0)
    return loads.max() * loads.shape[0] / total


def route_with_plan(plan: RoutePlan, payload: Tensor,
                    active: Optional[Tensor] = None,
                    role: str = "req") -> Routed:
    """Issue one payload phase against a precomputed plan: a pure scatter
    (no sort) + ONE exchange.

    active, when given, must be a subset of the plan's valid mask; it rides
    along as one extra payload word and is ANDed into the plan occupancy,
    so a shrinking probe-loop mask costs no extra exchange. Inactive ops
    leave holes instead of compacting, which keeps the (src_rank, slot)
    serialization order of the surviving ops."""
    nranks = plan.nranks
    cap = plan.cap
    if active is not None:
        payload = torch.cat(
            [payload, active.to(payload.dtype)[..., None]], dim=-1)
    keep = (plan.dst_eff < nranks) & (plan.op_slot < cap)
    buf = _scatter_slots(plan.dst_eff, plan.op_slot.to(torch.int64), keep,
                         payload, nranks, cap)
    at_owner = exchange(buf, role)                 # (P_owner, P_src, cap, W')
    if active is not None:
        mask = plan.mask & (at_owner[..., -1] != 0)
        at_owner = at_owner[..., :-1]
        op_ok = plan.op_ok & active
    else:
        mask = plan.mask
        op_ok = plan.op_ok
    return Routed(at_owner=at_owner, mask=mask, op_slot=plan.op_slot,
                  op_ok=op_ok, dropped=plan.dropped)


def route(dst: Tensor, payload: Tensor, cap: int,
          valid: Optional[Tensor] = None, role: str = "req") -> Routed:
    """Route op batches from all P origins to their owners (one phase).

    dst (P, n) destination ranks; payload (P, n, W); valid (P, n) optional.
    Loops issuing several phases to the same destinations should call
    `make_plan` once and `route_with_plan` per phase instead."""
    nranks = dst.shape[0]
    binned = bin_by_dest(dst, payload, nranks, cap, valid)
    at_owner = exchange(binned.buf, role)          # (P_owner, P_src, cap, W)
    mask = exchange(binned.mask, role + "_mask")   # (P_owner, P_src, cap)
    return Routed(at_owner=at_owner, mask=mask, op_slot=binned.op_slot,
                  op_ok=binned.op_ok, dropped=binned.dropped)


def route_replies(routed: Routed, replies: Tensor, dst: Tensor,
                  role: str = "rep") -> Tensor:
    """Return replies to origins and align them with the original op order.

    replies: (P_owner, P_src, cap, W) owner-side, aligned with at_owner
    dst:     (P, n) original destination ranks
    returns: (P, n, W) reply words per original op (garbage where ~op_ok;
             the garbage is the same word JAX's clamped gather reads)
    """
    back = exchange(replies, role)        # (P_origin, P_owner, cap, W)
    P, Q, cap = back.shape[:3]
    d = intops.clip_index(dst, Q)
    s = intops.clip_index(routed.op_slot, cap)
    flat = back.reshape((P, Q * cap) + back.shape[3:])
    return _gather_rows(flat, d * cap + s)


# ---------------------------------------------------------------------------
# Sender-side coalescing: dedup duplicate (dst, off) descriptor rows per
# origin BEFORE the exchange (one local sort, zero extra exchanges);
# replies fan back out to every duplicate requester via `lead`.
#
# A *run* is a maximal group of ops from one origin that target the same
# (dst, off), agree on every `match` column, and are consecutive once the
# batch is stably sorted by (dst, off).
# ---------------------------------------------------------------------------
@dataclass
class Coalescing:
    """Duplicate-run structure for one batch (per-origin, sender-side).

    rep:       (P, n) op is its run's representative (first in op order)
    leader:    (P, n) op index (within n) of each op's representative
    pos:       (P, n) rank of the op within its run (0 == rep)
    order:     (P, n) the (dst, off)-stable sort permutation runs live in
    run_first: (P, n) run boundaries, in sorted space
    rows_in:   (P,)   valid rows before combining
    rows_out:  (P,)   representative rows after combining
    """

    rep: Tensor
    leader: Tensor
    pos: Tensor
    order: Tensor
    run_first: Tensor
    rows_in: Tensor
    rows_out: Tensor

    def dedup_ratio(self) -> Tensor:
        """Distinct-row fraction rows_out / rows_in over all origins."""
        tot = torch.clamp(self.rows_in.sum(), min=1)
        return self.rows_out.sum().to(torch.float32) / tot


def coalesce(dst: Tensor, off: Tensor, match: Optional[Tensor] = None,
             valid: Optional[Tensor] = None) -> Coalescing:
    """Find duplicate runs in a batch of (dst, off[, match]) descriptors.

    dst, off: (P, n) int32; match: optional (P, n, K) extra descriptor
    words that must ALL agree for two rows to share a run. Invalid ops
    never join a run. Pure local compute, one sort per origin."""
    nranks, n = dst.shape
    dev = dst.device
    if valid is None:
        valid = torch.ones_like(dst, dtype=torch.bool)
    dst_eff = torch.where(valid, dst, nranks).to(torch.int64)
    off_eff = torch.where(valid, off, -1).to(torch.int64)
    # lexsort((seq, off_eff, dst_eff)) as one stable sort on a packed key
    key = (dst_eff << 32) | (off_eff + 2 ** 31)
    order = torch.argsort(key, dim=1, stable=True)
    d_s = torch.gather(dst_eff, 1, order)
    o_s = torch.gather(off_eff, 1, order)
    v_s = torch.gather(valid, 1, order)
    same = ((d_s[:, 1:] == d_s[:, :-1]) & (o_s[:, 1:] == o_s[:, :-1])
            & v_s[:, 1:] & v_s[:, :-1])
    if match is not None:
        m_s = _gather_rows(match, order)
        same = same & torch.all(m_s[:, 1:] == m_s[:, :-1], dim=-1)
    run_first = torch.cat(
        [torch.ones((nranks, 1), dtype=torch.bool, device=dev), ~same], 1)
    idx = torch.arange(n, device=dev)
    run_start = _prefix_max(torch.where(run_first, idx, -1))
    pos_s = (idx - run_start).to(torch.int32)
    leader_s = torch.gather(order, 1, run_start).to(torch.int32)
    rep_s = run_first & v_s
    return Coalescing(rep=_scatter_rows(order, rep_s),
                      leader=_scatter_rows(order, leader_s),
                      pos=_scatter_rows(order, pos_s),
                      order=order.to(torch.int32), run_first=run_first,
                      rows_in=valid.sum(1).to(torch.int32),
                      rows_out=rep_s.sum(1).to(torch.int32))


def lead(co: Coalescing, x: Tensor) -> Tensor:
    """Reply fan-out: every op reads its run representative's row of `x`
    (P, n, ...)."""
    return _gather_rows(x, co.leader.to(torch.int64))


def _run_end(co: Coalescing) -> Tensor:
    """Sorted-space index of the last member of each op's run."""
    P, n = co.run_first.shape
    idx = torch.arange(n, device=co.run_first.device)
    run_last = torch.cat([co.run_first[:, 1:], torch.ones_like(
        co.run_first[:, :1])], 1)
    return _suffix_min(torch.where(run_last, idx, n - 1))


def coalesce_fold(co: Coalescing, operand: Tensor, kind: int
                  ) -> Tuple[Tensor, Tensor]:
    """Fold duplicate runs of `operand` (P, n) with fetch-and-op `kind`.

    Returns (combined, prefix): `combined` carries each run's total fold at
    its representative row (other rows unchanged, never shipped);
    `prefix[i]` is the exclusive fold of the op's EARLIER run members
    (identity at representatives), so per-op old values reconstruct as
    fao(kind, owner_old_at_rep, prefix)."""
    order = co.order.to(torch.int64)
    op_s = torch.gather(operand, 1, order)
    incl = intops.seg_scan(op_s, co.run_first, kind)
    ident = torch.full_like(op_s, intops.IDENTITY[kind])
    excl = torch.where(co.run_first, ident, torch.roll(incl, 1, dims=1))
    combined_s = torch.where(co.run_first,
                             torch.gather(incl, 1, _run_end(co)), op_s)
    return _scatter_rows(order, combined_s), _scatter_rows(order, excl)


def coalesce_last(co: Coalescing, vals: Tensor) -> Tensor:
    """Last-writer-wins combine for put payloads (P, n, V): each
    representative row is replaced by the LAST value of its run."""
    order = co.order.to(torch.int64)
    vals_s = _gather_rows(vals, order)
    out_s = torch.where(co.run_first[..., None],
                        _gather_rows(vals_s, _run_end(co)), vals_s)
    return _scatter_rows(order, out_s)


@dataclass
class CoalescedPlan:
    """A RoutePlan whose occupancy covers only duplicate-run
    representatives, plus the Coalescing that maps every op to its
    representative. Callers reusing it across phases must keep their
    active mask RUN-UNIFORM (a run deactivates as a whole)."""

    plan: RoutePlan
    co: Coalescing

    @property
    def cap(self) -> int:
        return self.plan.cap


def coalesce_plan(dst: Tensor, off: Tensor, match: Optional[Tensor] = None,
                  valid: Optional[Tensor] = None, cap: Optional[int] = None,
                  role: str = "plan") -> CoalescedPlan:
    """Coalescing + route plan for a batch: still ONE occupancy exchange,
    for the representative rows only."""
    co = coalesce(dst, off, match=match, valid=valid)
    plan = make_plan(dst, valid=co.rep, cap=cap, role=role)
    return CoalescedPlan(plan=plan, co=co)


def miss_subset_plan(dst: Tensor, off: Tensor, hit: Optional[Tensor],
                     match: Optional[Tensor] = None,
                     valid: Optional[Tensor] = None,
                     cap: Optional[int] = None,
                     role: str = "plan") -> CoalescedPlan:
    """`coalesce_plan` restricted to the cache-miss subset.

    `hit` is the origin-local hot-bucket cache's hit mask for the batch
    (None: no cache consulted, exactly `coalesce_plan`). The hits leave
    the plan's validity before the occupancy exchange, so the plan is the
    one built for a batch that never held the hit rows. Still ONE
    occupancy exchange; an all-hit batch should build no plan at all (the
    caller's job)."""
    if hit is not None:
        hit = torch.as_tensor(hit, dtype=torch.bool, device=dst.device)
        valid = ~hit if valid is None else (valid & ~hit)
    return coalesce_plan(dst, off, match=match, valid=valid, cap=cap,
                         role=role)


def flatten_owner_view(routed: Routed) -> Tuple[Tensor, Tensor]:
    """Flatten an owner's (P_src, cap) request grid into a serialized op
    list in (src_rank, slot) order: the deterministic order in which the
    owner's "NIC lane" applies conflicting atomics.

    returns payload (P_owner, m, W), mask (P_owner, m), m = P_src*cap."""
    p, s, c = routed.mask.shape
    flat = routed.at_owner.reshape((p, s * c) + routed.at_owner.shape[3:])
    mask = routed.mask.reshape(p, s * c)
    return flat, mask


def unflatten_owner_view(flat: Tensor, p_src: int, cap: int) -> Tensor:
    p = flat.shape[0]
    return flat.reshape((p, p_src, cap) + flat.shape[2:])
