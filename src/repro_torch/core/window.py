"""PGAS symmetric window + one-sided (RDMA-style) component operations
(port of `repro.core.window`).

A `Window` is the analogue of a registered RDMA memory region: every rank
owns row `r` of a `(P, L)` int32 word tensor. Component ops are batched per
step and each op is ONE network phase:

    rdma_put   — 1 exchange  (origin → owner scatter; completion at phase end)
    rdma_get   — 2 exchanges (request → owner gather → reply)
    rdma_cas   — 2 exchanges (request → serialized apply → old values back)
    rdma_fao   — 2 exchanges (FAA / FOR / FAND / FXOR)
    rdma_txn_commit — 2 exchanges (groups of ops, all-or-nothing)

Conflicting atomics at an owner are applied in deterministic (src_rank,
slot) order, the analogue of NIC arrival-order serialization.

Which owner lane runs is decided by the device of the window's tensor:
on CUDA, `rdma_fao` and `rdma_cas` go through the `amo_apply` kernel,
every fused phase through the `fused_apply` kernel
(kernels/csrc/owner_lane.cu) and a txn commit through `txn_group_apply`
(kernels/csrc/txn_lane.cu); on the CPU the vectorized appliers below run,
as the JAX package's default XLA lane does, and the commit the plain
`txn_group_apply`. `rdma_put` and `rdma_get`
are tensor code on both devices. Both lanes implement the same serialized
contract; tests/test_torch_window.py holds the appliers against JAX's and
chip_smoke.py holds the CUDA lane against the CPU lane.

Reply words of invalid/undelivered ops are garbage by contract (callers
mask with their own valid/delivered flags); put completion is phase-end.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import intops
from ..kernels import ops as kops
from . import faults as flt
from . import routing
from .types import AmoKind

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Decision / pipeline-slot tagging: phases issued inside `decision_scope`
# or `slot_scope` are recorded in a bounded ring, as in the JAX package.
# ---------------------------------------------------------------------------
_CURRENT_DECISION = None
_CURRENT_SLOT: Optional[Tuple[int, int]] = None
# The hot-bucket cache of the table op in progress (`cache_scope`).
_CURRENT_CACHE = None
# Pipelines holding unforced in-flight batches (core/pipeline.py notes
# every transition). A WeakSet, so an abandoned pipeline never counts.
_INFLIGHT_PIPES: "weakref.WeakSet" = weakref.WeakSet()


def note_pipeline_inflight(pipe, active: bool) -> None:
    """Record whether `pipe` currently holds unforced in-flight batches."""
    if active:
        _INFLIGHT_PIPES.add(pipe)
    else:
        _INFLIGHT_PIPES.discard(pipe)


def pipeline_inflight() -> bool:
    """True while ANY pipeline holds unforced in-flight batches."""
    return len(_INFLIGHT_PIPES) > 0


PHASE_LOG_MAX = 4096
_PHASE_LOG: List[Tuple[str, object, Optional[dict]]] = []


@contextlib.contextmanager
def decision_scope(decision):
    global _CURRENT_DECISION
    prev = _CURRENT_DECISION
    _CURRENT_DECISION = decision
    try:
        yield
    finally:
        _CURRENT_DECISION = prev


@contextlib.contextmanager
def slot_scope(slot: int, seq: int):
    """Tag every phase issued inside the scope with its pipeline slot."""
    global _CURRENT_SLOT
    prev = _CURRENT_SLOT
    _CURRENT_SLOT = (int(slot), int(seq))
    try:
        yield
    finally:
        _CURRENT_SLOT = prev


@contextlib.contextmanager
def cache_scope(cache):
    """Make `cache` (core/cache.BucketCache) the active hot-bucket cache.

    Inside the scope, publish-capable phases (`rdma_cas_put_publish`,
    `rdma_cas_put`, FXOR `rdma_fao` / `rdma_fao_get`) forward their
    (dst, off) flips to `cache.on_publish`, the precision invalidation
    channel; the cache logs cache_fill / cache_hit / cache_invalidate
    events into the phase log (`log_cache_event`). Cache hits issue no
    phase."""
    global _CURRENT_CACHE
    prev = _CURRENT_CACHE
    _CURRENT_CACHE = cache
    try:
        yield
    finally:
        _CURRENT_CACHE = prev


def log_cache_event(role: str, info: Optional[dict] = None) -> None:
    """Log one cache event into the phase log, with the tagging rules of
    `_route_phase` (only inside a decision or slot scope). Cache events are
    not network phases: exchanges are counted by the routing hook."""
    if _CURRENT_DECISION is None and _CURRENT_SLOT is None:
        return
    merged = dict(info or {})
    if _CURRENT_SLOT is not None:
        merged["slot"], merged["seq"] = _CURRENT_SLOT
    _PHASE_LOG.append((role, _CURRENT_DECISION, merged or None))
    if len(_PHASE_LOG) > PHASE_LOG_MAX:
        del _PHASE_LOG[:-PHASE_LOG_MAX]


def _notify_publish(dst: Tensor, off: Tensor,
                    valid: Optional[Tensor]) -> None:
    """Forward a publish flip to the active cache (no-op without one).

    A publish inside a probe or CAS loop (`faults.loop_scope`) is not
    forwarded: the JAX package traces those loops, its offsets there are
    tracers and its cache ignores them. The cache's authoritative channel
    (`on_insert_keys`) covers those writes."""
    if _CURRENT_CACHE is not None and not flt.in_traced_loop():
        _CURRENT_CACHE.on_publish(dst, off, valid)


def drain_phase_log() -> List[Tuple[str, object, Optional[dict]]]:
    """Return and clear the (role, decision, info) log of tagged phases."""
    out = list(_PHASE_LOG)
    _PHASE_LOG.clear()
    return out


def _coalesce_info(co: Optional[routing.Coalescing]) -> Optional[dict]:
    if co is None:
        return None
    ri = int(co.rows_in.sum())
    ro = int(co.rows_out.sum())
    return {"coalesced": True, "rows_in": ri, "rows_out": ro,
            "dedup_ratio": ro / max(ri, 1)}


def _phase_info(co: Optional[routing.Coalescing]) -> Optional[dict]:
    info = _coalesce_info(co)
    if _CURRENT_SLOT is not None:
        info = dict(info or {})
        info["slot"], info["seq"] = _CURRENT_SLOT
    return info


@dataclass
class Window:
    """Symmetric PGAS window: rank r owns data[r]. Word-addressed."""

    data: Tensor  # (P, L) int32

    @property
    def nranks(self) -> int:
        return self.data.shape[0]

    @property
    def local_size(self) -> int:
        return self.data.shape[1]


def make_window(nranks: int, local_size: int, dtype=torch.int32, fill=0,
                device="cuda") -> Window:
    return Window(data=torch.full((nranks, local_size), fill, dtype=dtype,
                                  device=device))


# ---------------------------------------------------------------------------
# Owner-side appliers, batched over owners: local (P, L), op lists (P, m)
# in serialized order (ops earlier in a row happen first).
# ---------------------------------------------------------------------------
def _bounds(off_s: Tensor) -> Tuple[Tensor, Tensor]:
    """(is_first, is_last) of the same-offset segments of sorted rows."""
    diff = off_s[:, 1:] != off_s[:, :-1]
    one = torch.ones_like(off_s[:, :1], dtype=torch.bool)
    return torch.cat([one, diff], 1), torch.cat([diff, one], 1)


def _sort_by_off(off_eff: Tensor):
    """Stable per-owner sort by offset and its segment boundaries."""
    order = torch.argsort(off_eff, dim=1, stable=True)
    off_s = torch.gather(off_eff, 1, order)
    return (order, off_s) + _bounds(off_s)


def _unsort(order: Tensor, x_s: Tensor) -> Tensor:
    return routing._scatter_rows(order, x_s)


def _segmented_combine(off_sorted, vals_sorted, init_vals, kind: int):
    """Segmented exclusive scan over same-offset groups (sorted by offset).

    Returns (old_per_op_sorted, final_value_per_op_sorted, is_last) with
    old_i = init ⊕ (operands of earlier ops at the same offset)."""
    is_first, is_last = _bounds(off_sorted)
    incl = intops.seg_scan(vals_sorted, is_first, kind)
    ident = torch.full_like(vals_sorted, intops.IDENTITY[kind])
    excl = torch.where(is_first, ident, torch.roll(incl, 1, dims=1))
    old = intops.fao(kind, init_vals, excl)
    final = intops.fao(kind, init_vals, incl)
    return old, final, is_last


def apply_fao_local(local: Tensor, off: Tensor, operand: Tensor,
                    mask: Tensor, kind: int) -> Tuple[Tensor, Tensor]:
    """Apply a homogeneous batch of fetch-and-op atomics to the shards.

    local (P, L); off/operand/mask (P, m) in serialized order.
    Returns (old_per_op, new_local). Masked ops are no-ops returning 0."""
    L = local.shape[1]
    kind = int(kind)
    off_eff = torch.where(mask, off, L)
    operand_eff = torch.where(mask, operand, intops.IDENTITY[kind])
    order, off_s, _, _ = _sort_by_off(off_eff)
    op_s = torch.gather(operand_eff, 1, order)
    init_vals = intops.get_fill(local, off_s)
    old_s, final_s, is_last = _segmented_combine(off_s, op_s, init_vals,
                                                 kind)
    new_local = intops.set_drop(local, torch.where(is_last, off_s, L),
                                final_s)
    old = _unsort(order, old_s)
    return torch.where(mask, old, 0), new_local


def _cas_chain(init_vals: Tensor, cmp_s: Tensor, new_s: Tensor,
               is_first: Tensor) -> Tuple[Tensor, Tensor]:
    """Chained CAS along sorted same-offset segments: op k sees the value
    left by the ops before it in its segment. One vectorized round per
    position-in-segment. Returns (cur, next) per op."""
    n = init_vals.shape[1]
    idx = torch.arange(n, device=init_vals.device)
    pos = idx - torch.cummax(torch.where(is_first, idx, 0), dim=1).values
    cur = init_vals
    nxt = torch.where(cur == cmp_s, new_s, cur)
    for t in range(1, int(pos.max()) + 1 if n else 0):
        sel = pos == t
        cur = torch.where(sel, torch.roll(nxt, 1, dims=1), cur)
        nxt = torch.where(sel, torch.where(cur == cmp_s, new_s, cur), nxt)
    return cur, nxt


def apply_cas_local(local: Tensor, off: Tensor, cmp: Tensor, new: Tensor,
                    mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Serialized batch of CAS ops against the shards, with exact chained
    semantics (op k sees the value left by ops <k at the same offset)."""
    L = local.shape[1]
    off_eff = torch.where(mask, off, L)
    order, off_s, is_first, is_last = _sort_by_off(off_eff)
    cmp_s = torch.gather(cmp, 1, order)
    new_s = torch.gather(new, 1, order)
    init_vals = intops.get_fill(local, off_s)
    old_s, val_s = _cas_chain(init_vals, cmp_s, new_s, is_first)
    new_local = intops.set_drop(local, torch.where(is_last, off_s, L), val_s)
    old = _unsort(order, old_s)
    return torch.where(mask, old, 0), new_local


def apply_put_local(local: Tensor, off: Tensor, vals: Tensor,
                    mask: Tensor) -> Tensor:
    """Last-writer-wins vector puts. off addresses word 0 of a V-word row.
    Only the last writer of each offset scatters: CUDA gives no order
    among repeated indices, so duplicates are masked before the scatter."""
    L = local.shape[1]
    V = vals.shape[-1]
    off_eff = torch.where(mask, off, L)
    order, off_s, _, is_last = _sort_by_off(off_eff)
    vals_s = routing._gather_rows(vals, order)
    row = (torch.where(is_last, off_s, L)[..., None]
           + torch.arange(V, device=local.device))
    return intops.set_drop(local, row, vals_s)


def gather_local(local: Tensor, off: Tensor, width: int) -> Tensor:
    """(P, m, width) words from each owner's shard at off (0 outside)."""
    idx = off[..., None] + torch.arange(width, device=local.device)
    return intops.get_fill(local, idx)


# ---------------------------------------------------------------------------
# One-sided phases (the public RDMA-style API). Every phase accepts an
# optional precomputed RoutePlan (routing.make_plan): probe loops that issue
# many phases to fixed destinations build ONE plan per batch and each phase
# becomes a pure scatter + one exchange.
# ---------------------------------------------------------------------------
def _default_cap(dst: Tensor, cap: Optional[int]) -> int:
    return dst.shape[1] if cap is None else cap


def _route_phase(dst: Tensor, payload: Tensor, cap: int,
                 valid: Optional[Tensor],
                 plan: Optional[routing.RoutePlan], role: str,
                 co: Optional[routing.Coalescing] = None) -> routing.Routed:
    if _CURRENT_DECISION is not None or _CURRENT_SLOT is not None:
        _PHASE_LOG.append((role, _CURRENT_DECISION, _phase_info(co)))
        if len(_PHASE_LOG) > PHASE_LOG_MAX:
            del _PHASE_LOG[:-PHASE_LOG_MAX]
    plane = flt.active_plane()
    if plane is not None:
        valid = plane.inject_phase(role, dst, valid)
    if plan is None:
        return routing.route(dst, payload, cap, valid, role=role)
    return routing.route_with_plan(plan, payload, active=valid, role=role)


def _coalesce_for(plan, coalesce: bool, dst: Tensor, off: Tensor,
                  match: Optional[Tensor], valid: Optional[Tensor]):
    """Resolve the coalescing structure for one phase.

    plan may be a RoutePlan, a CoalescedPlan (its runs are reused; the
    caller keeps the active mask run-uniform), or None. coalesce=True
    without a CoalescedPlan computes fresh runs for THIS phase. Returns
    (base_plan, co, eff_valid), eff_valid restricted to representatives."""
    if isinstance(plan, routing.CoalescedPlan):
        co, plan = plan.co, plan.plan
    elif coalesce:
        co = routing.coalesce(dst, off, match=match, valid=valid)
    else:
        return plan, None, valid
    eff = co.rep if valid is None else (valid & co.rep)
    return plan, co, eff


def _bcast(x, like: Tensor) -> Tensor:
    """x (a Python scalar or a tensor) as an int32 tensor of like's shape
    on its device. A scalar is filled on the device: no host copy, which
    on CUDA would wait for the work already queued."""
    if isinstance(x, (int, np.integer)):
        return torch.full(like.shape, int(x), dtype=torch.int32,
                          device=like.device)
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.int32, device=like.device),
        like.shape).contiguous()


def rdma_put(win: Window, dst: Tensor, off: Tensor, vals: Tensor,
             valid: Optional[Tensor] = None, cap: Optional[int] = None,
             plan: Optional[routing.RoutePlan] = None,
             coalesce: bool = False) -> Window:
    """One-sided put: vals (P, n, V) written at word offsets off on rank dst.

    ONE network phase; remote-complete at phase end. coalesce=True dedups
    duplicate (dst, off) rows sender-side (last writer wins, bit-exact)."""
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off, None,
                                        valid)
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    V = vals.shape[-1]
    vals = vals.to(torch.int32)
    if co is not None:
        vals = routing.coalesce_last(co, vals)
    payload = torch.cat([off[..., None].to(torch.int32), vals], dim=-1)
    routed = _route_phase(dst, payload, cap, eff_valid, plan, role="put",
                          co=co)
    flat, mask = routing.flatten_owner_view(routed)
    new_data = apply_put_local(win.data, flat[..., 0], flat[..., 1:1 + V],
                               mask)
    return Window(data=new_data)


def rdma_get(win: Window, dst: Tensor, off: Tensor, width: int,
             valid: Optional[Tensor] = None, cap: Optional[int] = None,
             plan: Optional[routing.RoutePlan] = None,
             coalesce: bool = False) -> Tensor:
    """One-sided get of `width` words: TWO exchanges (request, data back).
    coalesce=True probes each duplicate (dst, off) once and fans out."""
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off, None,
                                        valid)
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    payload = off[..., None].to(torch.int32)
    routed = _route_phase(dst, payload, cap, eff_valid, plan, role="get",
                          co=co)
    flat, mask = routing.flatten_owner_view(routed)
    vals = gather_local(win.data, flat[..., 0], width)
    vals = torch.where(mask[..., None], vals, 0)
    replies = routing.unflatten_owner_view(vals, win.nranks, cap)
    out = routing.route_replies(routed, replies, dst, role="get_rep")
    if co is not None:
        out = routing.lead(co, out)
    return out


def _kernel_amo(data: Tensor, flat: Tensor, mask: Tensor, kind: int,
                a_col: int, b_col: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The CUDA owner lane: one `amo_apply` launch for the phase."""
    a = flat[..., a_col]
    ops_arr = torch.stack(
        [flat[..., 0], torch.full_like(a, int(kind)), a,
         flat[..., b_col] if b_col is not None else torch.zeros_like(a)],
        dim=-1)
    return kops.amo_apply(data, ops_arr, mask)


def rdma_fao(win: Window, dst: Tensor, off: Tensor, operand,
             kind: AmoKind, valid: Optional[Tensor] = None,
             cap: Optional[int] = None,
             plan: Optional[routing.RoutePlan] = None,
             coalesce: bool = False) -> Tuple[Tensor, Window]:
    """Fetch-and-op (FAA/FOR/FAND/FXOR): TWO exchanges, serialized apply.

    coalesce=True combines duplicate (dst, off) runs sender-side (operand
    fold) and reconstructs each duplicate's fetched value from the
    representative's reply plus its exclusive operand prefix."""
    kind = int(kind)
    if kind == int(AmoKind.FXOR):
        _notify_publish(dst, off, valid)
    operand = _bcast(operand, off)
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off, None,
                                        valid)
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    if co is not None:
        operand_wire, prefix = routing.coalesce_fold(co, operand, kind)
    else:
        operand_wire = operand
    payload = torch.stack([off.to(torch.int32), operand_wire], dim=-1)
    routed = _route_phase(dst, payload, cap, eff_valid, plan, role="fao",
                          co=co)
    flat, mask = routing.flatten_owner_view(routed)
    if win.data.is_cuda:
        old_flat, new_data = _kernel_amo(win.data, flat, mask, kind,
                                         a_col=1, b_col=None)
    else:
        old_flat, new_data = apply_fao_local(win.data, flat[..., 0],
                                             flat[..., 1], mask, kind)
    replies = routing.unflatten_owner_view(old_flat[..., None], win.nranks,
                                           cap)
    old = routing.route_replies(routed, replies, dst, role="fao_rep")[..., 0]
    if co is not None:
        old = intops.fao(kind, routing.lead(co, old), prefix)
    return old, Window(data=new_data)


def rdma_cas(win: Window, dst: Tensor, off: Tensor, cmp, new,
             valid: Optional[Tensor] = None, cap: Optional[int] = None,
             plan: Optional[routing.RoutePlan] = None,
             coalesce: bool = False) -> Tuple[Tensor, Window]:
    """Compare-and-swap: TWO exchanges, serialized chained apply.

    coalesce=True ships one representative per run of IDENTICAL
    (dst, off, cmp, new) rows; duplicates short-circuit sender-side with
    the chained outcome (rep won -> they see `new`, else the same old)."""
    cmp = _bcast(cmp, off)
    new = _bcast(new, off)
    match = torch.stack([cmp, new], dim=-1)
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off, match,
                                        valid)
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    payload = torch.stack([off.to(torch.int32), cmp, new], dim=-1)
    routed = _route_phase(dst, payload, cap, eff_valid, plan, role="cas",
                          co=co)
    flat, mask = routing.flatten_owner_view(routed)
    if win.data.is_cuda:
        old_flat, new_data = _kernel_amo(win.data, flat, mask,
                                         int(AmoKind.CAS), a_col=1, b_col=2)
    else:
        old_flat, new_data = apply_cas_local(win.data, flat[..., 0],
                                             flat[..., 1], flat[..., 2],
                                             mask)
    replies = routing.unflatten_owner_view(old_flat[..., None], win.nranks,
                                           cap)
    old = routing.route_replies(routed, replies, dst, role="cas_rep")[..., 0]
    if co is not None:
        old_l = routing.lead(co, old)
        old = torch.where(co.pos == 0, old_l,
                          torch.where(old_l == cmp, new, old_l))
    return old, Window(data=new_data)


# ---------------------------------------------------------------------------
# Fused component phases: composite one-phase remote ops. Descriptor layout
# [off | kind | a | b | aux0 | aux1 | vals...]. The owner applies the batch
# in SUB-PHASE order (atomics, compound puts, publish flips, phase-end
# gathers, each serialized in (src_rank, slot) order), exactly the order the
# unfused engine's separate phases would apply.
# ---------------------------------------------------------------------------
def _put_rows(local: Tensor, base: Tensor, vals: Tensor,
              mask: Tensor) -> Tensor:
    """Scatter V-word rows at `base`, dropped whole when out of range.
    Rows must be mutually disjoint (the caller's contract)."""
    L = local.shape[1]
    V = vals.shape[-1]
    ok = mask & (base >= 0) & (base <= L - V)
    row = (torch.where(ok, base, L)[..., None]
           + torch.arange(V, device=local.device))
    return intops.set_drop(local, row, vals)


def apply_cas_put_local(local: Tensor, off: Tensor, cmp: Tensor, new: Tensor,
                        put_off: Tensor, vals: Tensor, flip: Tensor,
                        mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Vectorized owner apply for a CAS_PUT / CAS_PUT_PUB batch:

      1. chained CAS sub-phase in serialized order;
      2. winners' puts as one disjoint-row scatter (dropped whole when out
         of range);
      3. publish flips folded into the flag scatter: the post-CAS value at
         each offset XOR the winners' flips.

    flip=0 rows are plain CAS_PUT. Returns (old, local'). Preconditions
    (engine batches meet them): winners' put rows are mutually disjoint
    and never cover other descriptors' `off` words; the generic lanes
    (kernels.ref.fused_apply, the CUDA kernel) are the spec otherwise."""
    L = local.shape[1]
    off_eff = torch.where(mask, off, L)
    order, off_s, is_first, is_last = _sort_by_off(off_eff)
    cmp_s = torch.gather(cmp, 1, order)
    new_s = torch.gather(new, 1, order)
    init_vals = intops.get_fill(local, off_s)
    old_s, val_s = _cas_chain(init_vals, cmp_s, new_s, is_first)
    win_s = old_s == cmp_s
    flip_contrib = torch.where(win_s, torch.gather(flip, 1, order), 0)
    xor_incl = intops.seg_scan(flip_contrib, is_first, intops.FXOR)
    flag_final = val_s ^ xor_incl
    new_local = intops.set_drop(local, torch.where(is_last, off_s, L),
                                flag_final)
    old = torch.where(mask, _unsort(order, old_s), 0)
    win = mask & (old == cmp)
    new_local = _put_rows(new_local, put_off, vals, win)
    return old, new_local


def apply_fao_get_local(local: Tensor, off: Tensor, operand: Tensor,
                        kind: int, get_off: Tensor, width: int, mask: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Vectorized owner apply for a FAO_GET batch: serialized fetch-and-op
    sub-phase, then a phase-end gather of `width` words from get_off.
    Returns (old, gathered (P, m, width), local')."""
    old, new_local = apply_fao_local(local, off, operand, mask, kind)
    rec = gather_local(new_local, get_off, width)
    return old, torch.where(mask[..., None], rec, 0), new_local


def _fused_phase(win: Window, dst: Tensor, desc: Tensor, reply_width: int,
                 valid: Optional[Tensor], cap: Optional[int],
                 plan: Optional[routing.RoutePlan], role: str, cpu_apply,
                 co: Optional[routing.Coalescing] = None
                 ) -> Tuple[Tensor, Window]:
    """Route one fused-descriptor phase and apply it at the owners.

    On CUDA the owners' lists go through one `fused_apply` launch; on the
    CPU through cpu_apply(data, flat, mask) -> (reply_flat, data'), the
    vectorized lane for this homogeneous batch. When `co` is given, `valid`
    is already restricted to representatives and the raw reply is fanned
    out to every duplicate (per-op fixups are the caller's job)."""
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    routed = _route_phase(dst, desc, cap, valid, plan, role=role, co=co)
    flat, mask = routing.flatten_owner_view(routed)
    if win.data.is_cuda:
        reply_flat, new_data = kops.fused_apply(win.data, flat, mask,
                                                reply_width=reply_width)
    else:
        reply_flat, new_data = cpu_apply(win.data, flat, mask)
    replies = routing.unflatten_owner_view(reply_flat, win.nranks, cap)
    out = routing.route_replies(routed, replies, dst, role=role + "_rep")
    if co is not None:
        out = routing.lead(co, out)
    return out, Window(data=new_data)


def _desc(off: Tensor, kind: int, a, b, aux0, aux1,
          vals: Optional[Tensor]) -> Tensor:
    cols = [off.to(torch.int32), _bcast(int(kind), off), _bcast(a, off),
            _bcast(b, off), _bcast(aux0, off), _bcast(aux1, off)]
    head = torch.stack(cols, dim=-1)
    if vals is None:
        return head
    return torch.cat([head, vals.to(torch.int32)], dim=-1)


def _cas_put_cpu_apply(data, flat, mask):
    V = flat.shape[-1] - 6
    old, data2 = apply_cas_put_local(
        data, flat[..., 0], flat[..., 2], flat[..., 3], flat[..., 4],
        flat[..., 6:6 + V], flat[..., 5], mask)
    return old[..., None], data2


def _cas_put_dup_fixup(old: Tensor, desc: Tensor,
                       co: Optional[routing.Coalescing]) -> Tensor:
    """Duplicates of a coalesced claim see the chained outcome."""
    if co is None:
        return old
    return torch.where(co.pos == 0, old,
                       torch.where(old == desc[..., 2], desc[..., 3], old))


def rdma_cas_put(win: Window, dst: Tensor, off: Tensor, cmp, new,
                 put_off: Tensor, vals: Tensor,
                 valid: Optional[Tensor] = None, cap: Optional[int] = None,
                 plan: Optional[routing.RoutePlan] = None,
                 coalesce: bool = False) -> Tuple[Tensor, Window]:
    """Fused claim + record write: CAS(cmp->new) at `off`; on success the
    V-word `vals` row lands at `put_off`, in ONE request phase + reply.
    Returns (old-at-off, win'). coalesce=True dedups runs of IDENTICAL
    descriptors (one claim ships, duplicates see the chained outcome)."""
    _notify_publish(dst, off, valid)
    desc = _desc(off, AmoKind.CAS_PUT, cmp, new, put_off, 0, vals)
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off,
                                        desc[..., 2:], valid)
    old, win2 = _fused_phase(win, dst, desc, 1, eff_valid, cap, plan,
                             role="cas_put", cpu_apply=_cas_put_cpu_apply,
                             co=co)
    return _cas_put_dup_fixup(old[..., 0], desc, co), win2


def rdma_cas_put_publish(win: Window, dst: Tensor, off: Tensor, cmp, new,
                         put_off: Tensor, vals: Tensor, flip,
                         valid: Optional[Tensor] = None,
                         cap: Optional[int] = None,
                         plan: Optional[routing.RoutePlan] = None,
                         coalesce: bool = False) -> Tuple[Tensor, Window]:
    """Fused claim + record write + publish: CAS(cmp->new) at `off`; on
    success write `vals` at `put_off` and flip mem[off] ^= `flip`, the C_RW
    insert's three logical ops in TWO exchanges. Returns (old-at-off, win')."""
    _notify_publish(dst, off, valid)
    desc = _desc(off, AmoKind.CAS_PUT_PUB, cmp, new, put_off, flip, vals)
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off,
                                        desc[..., 2:], valid)
    old, win2 = _fused_phase(win, dst, desc, 1, eff_valid, cap, plan,
                             role="cas_put_pub",
                             cpu_apply=_cas_put_cpu_apply, co=co)
    return _cas_put_dup_fixup(old[..., 0], desc, co), win2


def rdma_txn_commit(win: Window, dst: Tensor, desc: Tensor,
                    valid: Optional[Tensor] = None,
                    cap: Optional[int] = None,
                    plan: Optional[routing.RoutePlan] = None
                    ) -> Tuple[Tensor, Window]:
    """Transactional commit phase: ship per-txn groups of primitive ops
    and apply them all-or-nothing at the owners.

    desc (P, n, 6) int32 rows [off | code | a | b | gid | chain]: codes
    0-6 as in the AMO lane, gid the committing source rank (the
    (src_rank, slot) order of `flatten_owner_view` keeps each group
    contiguous at every owner), chain != 0 marks an OP_CAS row as a chain
    guard whose failed compare aborts its whole group at the owner. TWO
    exchanges: request + [old-at-apply | applied] replies, from the
    serialized apply itself. The owner lane is `kops.txn_group_apply`
    (the B9 kernel on CUDA, the plain version on the CPU).

    Never coalesced: every commit row must apply exactly once."""
    cap = plan.cap if plan is not None else _default_cap(dst, cap)
    routed = _route_phase(dst, desc.to(torch.int32), cap, valid, plan,
                          role="txn_commit")
    flat, mask = routing.flatten_owner_view(routed)
    reply_flat, new_data = kops.txn_group_apply(win.data, flat, mask,
                                                ngroups=win.nranks)
    replies = routing.unflatten_owner_view(reply_flat, win.nranks, cap)
    out = routing.route_replies(routed, replies, dst, role="txn_commit_rep")
    return out, Window(data=new_data)


def rdma_fao_get(win: Window, dst: Tensor, off: Tensor, operand,
                 kind: AmoKind, get_off, width: int,
                 valid: Optional[Tensor] = None, cap: Optional[int] = None,
                 plan: Optional[routing.RoutePlan] = None,
                 coalesce: bool = False) -> Tuple[Tensor, Tensor, Window]:
    """Fused fetch-and-op + gather: apply FAO(`operand`, `kind`) at `off`
    and return `width` words from `get_off` in the SAME request/reply pair.
    The gather is a phase-end snapshot. Returns (old-at-off,
    gathered (P, n, width), win').

    coalesce=True combines duplicate (dst, off, get_off) runs; duplicates
    reconstruct their fetched value from the representative's reply +
    their operand prefix and share the gathered record."""
    kind = int(kind)
    if kind not in intops.IDENTITY:
        raise ValueError(f"rdma_fao_get needs a fetch-and-op kind, not {kind}")
    if kind == int(AmoKind.FXOR):
        _notify_publish(dst, off, valid)
    operand = _bcast(operand, off)
    get_off_b = _bcast(get_off, off)
    plan, co, eff_valid = _coalesce_for(plan, coalesce, dst, off,
                                        get_off_b[..., None], valid)
    if co is not None:
        operand_wire, prefix = routing.coalesce_fold(co, operand, kind)
    else:
        operand_wire = operand
    desc = _desc(off, AmoKind.FAO_GET, operand_wire, kind, get_off_b, 0,
                 None)

    def cpu_apply(data, flat, mask):
        old, rec, data2 = apply_fao_get_local(
            data, flat[..., 0], flat[..., 2], kind, flat[..., 4], width, mask)
        return torch.cat([old[..., None], rec], dim=-1), data2

    reply, win2 = _fused_phase(win, dst, desc, 1 + width, eff_valid, cap,
                               plan, role="fao_get", cpu_apply=cpu_apply,
                               co=co)
    old = reply[..., 0]
    if co is not None:
        old = intops.fao(kind, old, prefix)
    return old, reply[..., 1:], win2
