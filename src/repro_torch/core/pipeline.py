"""Pipelined in-flight batch engine: futures-style op handles over
double-buffered exchange windows (port of `repro.core.pipeline`,
DESIGN.md §7).

    pipe = Pipeline(ht, depth=2)               # two in-flight windows
    h1 = hashtable.insert_async(pipe, k1, v1)  # batch 0: staged, in flight
    h2 = hashtable.find_async(pipe, k2)        # batch 1 stages while batch
    ok, probes = h1.result()                   #   0 runs on the device
    ht = pipe.flush()                          # force everything, get state

`submit` stages a batch (its kernels are queued on the device's stream)
and returns a `Handle` without waiting for the device. `Handle.result()`
forces completion. `depth` counts exchange windows, INCLUDING the one
being staged: with `depth >= 2` batches stay in flight across submits, so
batch k+1's host staging (and the caller's compute in between) overlaps
batch k's device work; `depth=1` is the lock-step engine, each submit
completing its own batch before it returns, bit for bit the synchronous
path.

How the overlap happens in the port: one CUDA stream, the one every
kernel and tensor op of the port is queued on. Batch k+1 reads batch k's
window, so the overlap is host against device, as JAX's asynchronous
dispatch gives it. Every phase returns new tensors (the kernels write
into fresh buffers), so the windows of two live batches are two buffers:
functional updates ARE the double buffering. After a batch's last launch
`_run` records a `torch.cuda.Event`; `Handle.done()` queries it, forcing
a handle synchronizes on it (never on the whole device, which would also
wait for later batches). Anything that reads a device value while a
batch stages (a probe round's stop flag, a pageable host-to-device copy)
makes the host wait for the batches before it: chip_smoke.py phase 12
counts those per batch. On the CPU there is nothing in flight, and a
staged handle is done.

Deferred (AM) batches: ops whose arm is an active message are submitted
with `deferred=True`. They wait in the `AMEngine` dispatch queue and
drain at the next *dispatch point*: the next eager submit, a `result()`,
or a `flush()` (`AMEngine.drain_dispatch_queue`). Their service latency
is the time to the next overlap window: the paper's attentiveness as a
measurable quantity.

Ordering contract: submission order IS serialization order. Deferred
batches drain before any later eager batch stages, so the state each
batch observes is the synchronous engine's (tests/test_torch_pipeline.py
holds async == sync == the JAX package on interleaved streams with
out-of-order forcing).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from . import faults as flt
from . import window as win_mod

# An op stages one batch against the current structure state and returns
# (state', outputs). Outputs are what Handle.result() yields.
OpFn = Callable[[Any], Tuple[Any, Any]]


def _tensors(x) -> Iterator[torch.Tensor]:
    """Every tensor in a tree of tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _completion_event(*trees) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream of the first CUDA device
    found in `trees` (None when every tensor lies on the CPU)."""
    for t in (t for tree in trees for t in _tensors(tree)):
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            return ev
    return None


class Handle:
    """Future for one submitted op batch.

    Created by `Pipeline.submit`; resolves to the batch's outputs, e.g.
    `(ok, probes)` for a hash-table insert. Handles may be forced in any
    order; forcing never changes values.
    """

    __slots__ = ("seq", "label", "deferred", "_pipe", "_op", "_outputs",
                 "_event", "_staged", "_forced", "_error")

    def __init__(self, pipe: "Pipeline", seq: int, label: Optional[str],
                 deferred: bool):
        self.seq = seq
        self.label = label
        self.deferred = deferred
        self._pipe = pipe
        self._op: Optional[OpFn] = None
        self._outputs: Any = None
        self._event: Optional[torch.cuda.Event] = None
        self._staged = False
        self._forced = False
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        """True when the batch's outputs are computed. Never blocks: a
        deferred batch still waiting for a dispatch point reports False,
        as does a staged batch whose device work is still queued."""
        if self._forced or self._error is not None:
            return True
        if not self._staged:
            return False
        return self._event is None or self._event.query()

    def result(self, timeout: Optional[int] = None) -> Any:
        """Force completion and return the batch's outputs.

        Drains the deferred-dispatch queue first if this batch (or an
        earlier one) is still waiting for a dispatch point, then waits for
        the batch's device work. Idempotent.

        timeout: under an active `faults.FaultPlan`, the number of
        simulated dispatch rounds to wait for a stalled deferred-AM queue
        before raising `faults.RemoteTimeout` (default: the plan's
        `RetryPolicy.deadline`); a permanently dead owner raises at once.
        Without a plan the engine cannot stall and the value is unused. A
        timed-out Handle stays failed: later calls raise the same error
        (its batch is guaranteed dropped, see `Pipeline.close`)."""
        self._pipe._force(self, timeout=timeout)
        return self._outputs


class Pipeline:
    """In-flight op-batch manager over a functionally threaded state.

    state:     the structure operated on (a `DHashTable`, a `DQueue`, or
               any value the submitted ops thread through).
    depth:     exchange windows, including the one being staged. 1 =
               lock-step (bit for bit the direct engine calls); 2 =
               double-buffered: at most one batch is left in flight when
               submit returns.
    am_engine: optional `am.AMEngine`. Deferred (AM-arm) submissions queue
               on it and drain at dispatch points; without one the
               pipeline keeps its own FIFO with the same semantics.
    auto_depth: the async front doors ask their AdaptiveEngine's
               `choose_depth` before each submit and retarget the window
               count with `set_depth`. `depth` becomes the cap.

    `Pipeline.state` is the latest *staged* state (its device values may
    still be in flight); `flush()` forces everything and returns it.
    """

    def __init__(self, state: Any, depth: int = 2, am_engine=None,
                 auto_depth: bool = False):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._state = state
        self.depth = depth
        self.am_engine = am_engine
        self.auto_depth = auto_depth
        self.max_depth = depth
        self._inflight: collections.deque = collections.deque()
        self._own_queue: collections.deque = collections.deque()
        self._last_event: Optional[torch.cuda.Event] = None
        self._seq = 0
        self._closed = False

    # -- context manager: teardown never strands batches ---------------------
    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            # clean exit: a full dispatch point; a RemoteTimeout of a
            # stalled queue propagates to the caller
            self.flush()
        else:
            # exception path: teardown that never masks the exception
            self.close()
        return False

    def close(self) -> None:
        """Teardown on the exception path: drain the deferred queue so no
        dispatch thunk is stranded, force every staged Handle, and fail
        the rest with `faults.RemoteTimeout`. Errors raised while doing so
        are dropped, so that the exception that closes the pipeline is
        the one the caller sees; every handle still either holds its
        outputs or raises when forced. Queued thunks of this pipeline
        become no-ops, so a later drain by another user of the engine
        cannot run a batch the caller was told had failed."""
        try:
            self._drain_deferred()
        except Exception:
            pass
        for h in list(self._inflight):
            if h._staged:
                try:
                    self._force(h)
                except Exception:
                    pass
            else:
                h._error = flt.RemoteTimeout(
                    f"pipeline closed with batch seq={h.seq} "
                    f"({h.label or 'op'}) never serviced")
                try:
                    self._inflight.remove(h)
                except ValueError:
                    pass
        self._closed = True
        self._own_queue.clear()
        self._note_inflight()

    def set_depth(self, depth: int) -> None:
        """Retarget the in-flight window count (the auto-depth hook).

        Clamped to [1, max_depth]. Shrinking forces the oldest batches at
        once so that at most `depth - 1` stay in flight; growing admits
        more windows. Safe between any two submits."""
        d = max(1, min(int(depth), self.max_depth))
        self.depth = d
        while len(self._inflight) > d - 1:
            self._force(self._inflight[0])

    def _note_inflight(self) -> None:
        win_mod.note_pipeline_inflight(self, bool(self._inflight))

    # -- introspection ------------------------------------------------------
    @property
    def staged_state(self) -> Any:
        """The raw staged state, WITHOUT draining deferred batches: for
        metadata reads at submit time (a table's `nranks` / `nslots`)."""
        return self._state

    @property
    def state(self) -> Any:
        """Latest staged state (drains pending deferred batches first;
        never waits for device work)."""
        self._drain_deferred()
        return self._state

    @property
    def in_flight(self) -> int:
        """Unforced batches currently tracked (staged + deferred)."""
        return len(self._inflight)

    @property
    def pending_deferred(self) -> int:
        """Deferred batches still waiting for a dispatch point."""
        if self.am_engine is not None:
            return self.am_engine.pending_dispatches
        return len(self._own_queue)

    # -- submission ---------------------------------------------------------
    def submit(self, op: OpFn, deferred: bool = False,
               label: Optional[str] = None) -> Handle:
        """Stage one op batch; returns its Handle at once.

        op: `state -> (state', outputs)`. Eager ops run now (their device
        work is queued; the host does not wait for it); `deferred=True`
        queues the op for the next dispatch point. Before returning, the
        oldest batches are forced until at most `depth - 1` remain in
        flight."""
        h = Handle(self, self._seq, label, deferred)
        self._seq += 1
        if not deferred:
            self._drain_deferred()
            if self.pending_deferred:
                # an inattentive owner still holds earlier deferred
                # batches: this one queues behind them (submission order
                # is serialization order, with or without faults)
                deferred = h.deferred = True
        if deferred:
            h._op = op
            self._enqueue(h)
        else:
            self._run(h, op)
        self._inflight.append(h)
        self._note_inflight()
        while len(self._inflight) > self.depth - 1:
            self._force(self._inflight[0])
        return h

    def flush(self) -> Any:
        """Force every in-flight batch (a dispatch point) and return the
        fully computed state."""
        self._drain_deferred()
        while self._inflight:
            self._force(self._inflight[0])
        if self._last_event is not None:
            self._last_event.synchronize()
        return self._state

    # -- internals ----------------------------------------------------------
    def _enqueue(self, h: Handle) -> None:
        def thunk():
            if self._closed or h._error is not None:
                return  # failed/closed batches are guaranteed dropped
            self._run(h, h._op)

        if self.am_engine is not None:
            self.am_engine.queue_dispatch(thunk)
        else:
            self._own_queue.append(thunk)

    def _run(self, h: Handle, op: OpFn) -> None:
        """Stage one batch: run the op against the current state inside the
        batch's slot scope, then record its completion event."""
        with win_mod.slot_scope(h.seq % self.depth, h.seq):
            state, outputs = op(self._state)
        self._state = state
        h._outputs = outputs
        h._event = _completion_event(outputs, state)
        if h._event is not None:
            self._last_event = h._event
        h._staged = True

    def _drain_deferred(self) -> None:
        """Enter a dispatch point: run every queued deferred batch FIFO."""
        if self.am_engine is not None:
            self.am_engine.drain_dispatch_queue()
        else:
            while self._own_queue:
                self._own_queue.popleft()()

    def _force(self, h: Handle, timeout: Optional[int] = None) -> None:
        if h._error is not None:
            raise h._error
        if h._forced:
            return
        if not h._staged:
            self._drain_deferred()
        if not h._staged:
            # the deferred queue refused to drain: an inattentive owner.
            # Keep offering service opportunities (each drain advances the
            # plane's round clock) up to `timeout` rounds, then fail typed;
            # a permanently dead owner fails without spinning.
            plane = flt.active_plane()
            if plane is not None:
                rounds = int(timeout if timeout is not None
                             else plane.retry.deadline)
                for _ in range(rounds):
                    if plane.queue_dead():
                        break
                    self._drain_deferred()
                    if h._staged:
                        break
                if not h._staged:
                    why = ("permanently dead" if plane.queue_dead()
                           else f"stalled past {rounds} rounds")
                    err = flt.RemoteTimeout(
                        f"batch seq={h.seq} ({h.label or 'op'}) not "
                        f"serviced: deferred-AM queue {why}")
                    h._error = err
                    try:
                        self._inflight.remove(h)
                    except ValueError:
                        pass
                    self._note_inflight()
                    raise err
        if not h._staged:
            raise RuntimeError(f"deferred batch seq={h.seq} did not stage "
                               f"at a dispatch point")
        if h._event is not None:
            h._event.synchronize()
        h._forced = True
        try:
            self._inflight.remove(h)
        except ValueError:
            pass
        self._note_inflight()


def submit_many(pipe: Pipeline, ops: List[OpFn]) -> List[Handle]:
    """Submit a list of ops in order, returning their handles."""
    return [pipe.submit(op) for op in ops]
