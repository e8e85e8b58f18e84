"""Active-message (RPC) engine (port of `repro.core.am`): aggregated request
routing + owner-local handlers.

- `dispatch` = ONE request exchange + an arbitrary owner-local handler +
  ONE reply exchange. The number of network phases is independent of the
  handler's control flow, the paper's central RPC property.
- Handlers obey the paper's AM restrictions by construction: they are pure
  functions of the owners' state, so they cannot send further messages.

Where the JAX engine vmaps a per-owner handler, a handler here takes all
owners at once: (state (P, ...), payload (P, m, W), mask (P, m)) ->
(state', replies (P, m, RW)).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from . import faults as flt
from . import routing

Tensor = torch.Tensor

HandlerFn = Callable[[Any, Tensor, Tensor], Tuple[Any, Tensor]]


@dataclass(frozen=True)
class Handler:
    """A registered active-message handler (paper Fig. 2's insert_handler).

    `batched_fn`, when provided, replaces `fn` in `dispatch`: it is the
    hook through which the CUDA handler kernels (kernels/hash_probe.py)
    take over the handler body. Both have the owner-batched signature.
    """

    name: str
    fn: HandlerFn
    reply_width: int  # int32 words returned per op (0 => no-reply AM)
    batched_fn: Optional[HandlerFn] = None

    @property
    def body(self) -> HandlerFn:
        return self.batched_fn if self.batched_fn is not None else self.fn


DISPATCH_LOG_MAX = 1024


class AMEngine:
    """Handler registry + dispatch. One engine per distributed structure."""

    def __init__(self, nranks: int, dispatch_log_max: int = DISPATCH_LOG_MAX):
        self.nranks = nranks
        self._handlers: dict[str, Handler] = {}
        # (handler name, decision, info) per dispatch issued with a decision
        self.dispatch_log: collections.deque = collections.deque(
            maxlen=dispatch_log_max)
        # Deferred-dispatch queue: AM batches wait here until the next
        # *dispatch point*, the paper's attentiveness made an explicit queue.
        self._pending: collections.deque = collections.deque()
        self.dispatch_points = 0

    def drain_dispatch_log(self):
        """Return and clear the (handler, decision, info) dispatch log."""
        out = list(self.dispatch_log)
        self.dispatch_log.clear()
        return out

    @property
    def pending_dispatches(self) -> int:
        """Queued dispatch thunks awaiting the next dispatch point."""
        return len(self._pending)

    def queue_dispatch(self, thunk) -> None:
        """Enqueue a zero-arg dispatch thunk for the next dispatch point."""
        self._pending.append(thunk)

    def drain_dispatch_queue(self) -> int:
        """Enter a dispatch point: service every queued dispatch, FIFO.
        Returns the number serviced; every entry counts a dispatch point.

        Under an active FaultPlan each call is one AM service opportunity:
        the plane's round clock ticks, and while the plan stalls the queue
        (`stall_rounds` / `stall_forever`) the queue does NOT drain and no
        dispatch point is counted (the owner never entered the runtime)."""
        plane = flt.active_plane()
        if plane is not None:
            stalled = plane.queue_stalled()
            plane.tick()
            if stalled:
                plane.stall_hits += 1
                return 0
        self.dispatch_points += 1
        count = len(self._pending)
        while self._pending:
            self._pending.popleft()()
        return count

    def register(self, name: str, fn: HandlerFn, reply_width: int,
                 batched_fn: Optional[HandlerFn] = None) -> Handler:
        if name in self._handlers:
            raise ValueError(f"handler {name!r} already registered")
        h = Handler(name=name, fn=fn, reply_width=reply_width,
                    batched_fn=batched_fn)
        self._handlers[name] = h
        return h

    def handler(self, name: str) -> Handler:
        return self._handlers[name]

    def has_handler(self, name: str) -> bool:
        return name in self._handlers

    def dispatch(self, handler: Handler, state: Any, dst: Tensor,
                 payload: Tensor, valid: Optional[Tensor] = None,
                 cap: Optional[int] = None,
                 plan: Optional[routing.RoutePlan] = None,
                 decision: Optional[Any] = None,
                 coalesce: bool = False) -> Tuple[Any, Tensor, Tensor]:
        """Issue one aggregated AM phase for a batch of requests.

        state:   owners' state, leading axis P
        dst:     (P, n) target ranks
        payload: (P, n, W) int32 request words
        plan:    optional precomputed RoutePlan reused across dispatches
        decision: recorded in `self.dispatch_log` when given
        coalesce: dedup IDENTICAL request rows to the same destination
                 sender-side; only for handlers idempotent across identical
                 requests (hash-table insert-or-assign and find are, a
                 queue push is not).
        returns (state', replies (P, n, RW), delivered (P, n)).

        Exactly two network phases regardless of handler complexity; one
        for reply_width == 0.
        """
        plane = flt.active_plane()
        if plane is not None:
            valid = plane.inject_am(dst, valid)
            plane.tick()
        co = None
        eff_valid = valid
        if coalesce:
            co = routing.coalesce(dst, payload[..., 0], match=payload,
                                  valid=valid)
            eff_valid = co.rep if valid is None else (valid & co.rep)
        if decision is not None:
            info = None
            if co is not None:
                from . import window as win_mod
                info = win_mod._coalesce_info(co)
            self.dispatch_log.append((handler.name, decision, info))
        if plan is not None:
            cap = plan.cap
            routed = routing.route_with_plan(plan, payload, active=eff_valid,
                                             role="am_req")
        else:
            cap = dst.shape[1] if cap is None else cap
            routed = routing.route(dst, payload, cap, eff_valid,
                                   role="am_req")
        flat, mask = routing.flatten_owner_view(routed)
        state2, reply_flat = handler.body(state, flat, mask)
        delivered = routed.op_ok
        if co is not None:
            # duplicates are delivered iff their representative was
            delivered = routing.lead(co, delivered)
            if valid is not None:
                delivered = delivered & valid
        if handler.reply_width == 0:
            replies = torch.zeros(dst.shape + (0,), dtype=torch.int32,
                                  device=dst.device)
            return state2, replies, delivered
        replies_o = routing.unflatten_owner_view(reply_flat, self.nranks, cap)
        replies = routing.route_replies(routed, replies_o, dst, role="am_rep")
        if co is not None:
            replies = routing.lead(co, replies)
        return state2, replies, delivered

    def dispatch_local(self, handler: Handler, state: Any, payload: Tensor,
                       valid: Optional[Tensor] = None) -> Tuple[Any, Tensor]:
        """Run the handler against each rank's own shard (C_l level): zero
        network phases."""
        if valid is None:
            valid = torch.ones(payload.shape[:-1], dtype=torch.bool,
                               device=payload.device)
        return handler.body(state, payload, valid)
