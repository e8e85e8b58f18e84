"""Distributed hosted queue (ring buffer) — paper §III-B2, Table III, Fig. 4
(port of `repro.core.queue`).

A ``DQueue`` lives on a single *host* rank but is visible to every rank. It
is a ring buffer with four control words followed by the data region:

    word 0: tail          (reserve frontier for pushes, advanced by FAA)
    word 1: tail_ready    (publish frontier: data below this is readable)
    word 2: head          (reserve frontier for pops)
    word 3: head_ready    (release frontier: space below this is reusable)

Implementations and their best-case costs (paper Table III):

  push C_RW (rdma):      A_FAO + W + A_CAS-P   (reserve, write, publish)
  push C_W  (rdma):      A_FAO + W             (barrier supplies the fence)
  push checksum C_RW:    A_FAO + W             (in-payload checksum word)
  pop  C_RW (rdma):      A_FAO + R + A_CAS-P
  pop  C_R  (rdma):      A_FAO + R
  push/pop C_L:          local vector ops, zero network phases
  push/pop (rpc):        one AM round trip + owner-side handler
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import intops
from . import am as am_mod
from . import faults as flt
from . import routing
from . import window as win_mod
from .types import AmoKind, Backend, Promise, as_backend, as_i32, as_mask
from .window import Window, rdma_cas, rdma_fao, rdma_get, rdma_put

Tensor = torch.Tensor

TAIL, TAIL_READY, HEAD, HEAD_READY = 0, 1, 2, 3
CTRL_WORDS = 4


@dataclass
class DQueue:
    """Hosted ring buffer. Slot i of the data region starts at word
    CTRL_WORDS + (i % capacity) * slot_w."""

    win: Window
    host: int
    capacity: int      # slots
    val_words: int     # payload words per slot
    checksum: bool = False  # slots carry a trailing checksum word

    @property
    def nranks(self) -> int:
        return self.win.nranks

    @property
    def slot_w(self) -> int:
        return self.val_words + (1 if self.checksum else 0)


def make_queue(nranks: int, host: int, capacity: int, val_words: int,
               checksum: bool = False, device="cuda") -> DQueue:
    slot_w = val_words + (1 if checksum else 0)
    win = win_mod.make_window(nranks, CTRL_WORDS + capacity * slot_w,
                              device=device)
    return DQueue(win=win, host=host, capacity=capacity,
                  val_words=val_words, checksum=checksum)


def _with_win(q: DQueue, win: Window) -> DQueue:
    return DQueue(win=win, host=q.host, capacity=q.capacity,
                  val_words=q.val_words, checksum=q.checksum)


def _csum(vals: Tensor) -> Tensor:
    """Checksum over the payload words of each slot (..., vw): FNV-style
    xor-multiply in wrapping int32, nonzero by construction (0 marks an
    unwritten slot)."""
    c = torch.full(vals.shape[:-1], 0x811C9DC5, dtype=torch.int64,
                   device=vals.device)
    for w in range(vals.shape[-1]):
        c = intops.mul_u32(c ^ intops.u32(vals[..., w]), 0x01000193)
    c = intops.i32(c)
    return torch.where(c == 0, 1, c)


def _host_dst(q: DQueue, shape) -> Tensor:
    return torch.full(shape, q.host, dtype=torch.int32,
                      device=q.win.data.device)


# ---------------------------------------------------------------------------
# RDMA backend — push
# ---------------------------------------------------------------------------
def push_rdma(q: DQueue, vals, promise: Promise = Promise.CRW, valid=None,
              max_cas_rounds: int = 8, planned: bool = True,
              coalesce: bool = False) -> Tuple[DQueue, Tensor]:
    """Batched push of vals (P, n, vw) onto the hosted ring buffer.

    Returns (queue', pushed (P, n) bool). Overflowing reservations are
    returned by one extra FAA and reported failed (the caller sizes the
    ring, as in BCL).

    planned=True (default): every component phase reuses ONE RoutePlan
    (the host destination never changes). coalesce=True: the reserve and
    failure-return FAOs send ONE wire row per origin, tickets reconstructed
    sender-side bit-exactly."""
    if promise not in (Promise.CRW, Promise.CW):
        raise ValueError(f"push promise must be CRW or CW, not {promise}")
    dev = q.win.data.device
    vals = as_i32(vals, dev)
    P, n, vw = vals.shape
    if vw != q.val_words:
        raise ValueError(f"push of {vw} words into a {q.val_words}-word "
                         f"queue")
    valid = as_mask(valid, (P, n), dev)
    dst = _host_dst(q, (P, n))
    use_csum = q.checksum and promise == Promise.CRW
    plan = (routing.make_plan(dst, valid, cap=n, role="q_push")
            if planned else None)

    # Phase 1 — A_FAO: reserve space by advancing `tail`.
    off_tail = torch.full((P, n), TAIL, dtype=torch.int32, device=dev)
    ticket, win = rdma_fao(q.win, dst, off_tail, 1, AmoKind.FAA,
                           valid=valid, plan=plan, coalesce=coalesce)

    # Ring-capacity check against head_ready; a full ring fails the push.
    head_ready = win.data[q.host, HEAD_READY]
    ok = valid & (ticket - head_ready < q.capacity)
    # Failed reservations are the top of the reserved range: return them.
    neg = torch.where(valid & ~ok, -1, 0).to(torch.int32)
    _, win = rdma_fao(win, dst, off_tail, neg, AmoKind.FAA,
                      valid=valid & ~ok, plan=plan, coalesce=coalesce)

    # Phase 2 — W: write the payload into the reserved slot.
    base = CTRL_WORDS + (ticket % q.capacity) * q.slot_w
    if use_csum:
        payload = torch.cat([vals, _csum(vals)[..., None]], dim=-1)
    elif q.checksum:
        # checksum layout but phasal promise: a zero checksum word
        payload = torch.cat([vals, torch.zeros_like(vals[..., :1])], dim=-1)
    else:
        payload = vals
    win = rdma_put(win, dst, base, payload, valid=ok, plan=plan)

    if promise == Promise.CRW and not use_csum:
        # Phase 3 — persistent CAS: advance tail_ready ticket -> ticket+1.
        # Each op may publish only once every earlier ticket has published.
        off_tr = torch.full((P, n), TAIL_READY, dtype=torch.int32,
                            device=dev)
        pending = ok
        with flt.loop_scope(dst, ("cas",)):
            for _ in range(max_cas_rounds):
                old, win = rdma_cas(win, dst, off_tr, ticket, ticket + 1,
                                    valid=pending, plan=plan)
                pending = pending & ~(old == ticket)
        ok = ok & ~pending  # unpublished pushes report failure
    return _with_win(q, win), ok


# ---------------------------------------------------------------------------
# RDMA backend — pop
# ---------------------------------------------------------------------------
def pop_rdma(q: DQueue, n: int, promise: Promise = Promise.CR, valid=None,
             max_cas_rounds: int = 8, planned: bool = True,
             coalesce: bool = False) -> Tuple[DQueue, Tensor, Tensor]:
    """Batched pop of up to n values per rank. Returns (q', got (P,n), vals).

    C_R : A_FAO (reserve head) + R (read slot).
    C_RW: A_FAO + R + persistent CAS advancing head_ready (release), the
          reservation validated against tail_ready.
    Failed pops report zero values."""
    if promise not in (Promise.CRW, Promise.CR):
        raise ValueError(f"pop promise must be CRW or CR, not {promise}")
    dev = q.win.data.device
    P = q.nranks
    valid = as_mask(valid, (P, n), dev)
    dst = _host_dst(q, (P, n))
    plan = (routing.make_plan(dst, valid, cap=n, role="q_pop")
            if planned else None)

    off_head = torch.full((P, n), HEAD, dtype=torch.int32, device=dev)
    ticket, win = rdma_fao(q.win, dst, off_head, 1, AmoKind.FAA,
                           valid=valid, plan=plan, coalesce=coalesce)

    # May only read below the publish frontier (checksum queues read below
    # `tail` and validate the in-payload checksum instead).
    use_ready = promise == Promise.CRW and not q.checksum
    frontier = win.data[q.host, TAIL_READY if use_ready else TAIL]
    got = valid & (ticket < frontier)
    neg = torch.where(valid & ~got, -1, 0).to(torch.int32)
    _, win = rdma_fao(win, dst, off_head, neg, AmoKind.FAA,
                      valid=valid & ~got, plan=plan, coalesce=coalesce)

    base = CTRL_WORDS + (ticket % q.capacity) * q.slot_w
    rec = rdma_get(win, dst, base, q.slot_w, valid=got, plan=plan)
    vals = rec[..., :q.val_words]

    if q.checksum and promise == Promise.CRW:
        got = got & (rec[..., -1] == _csum(vals))

    if promise == Promise.CRW:
        off_hr = torch.full((P, n), HEAD_READY, dtype=torch.int32,
                            device=dev)
        pending = got
        with flt.loop_scope(dst, ("cas",)):
            for _ in range(max_cas_rounds):
                old, win = rdma_cas(win, dst, off_hr, ticket, ticket + 1,
                                    valid=pending, plan=plan)
                pending = pending & ~(old == ticket)
    vals = torch.where(got[..., None], vals, 0)
    return _with_win(q, win), got, vals


# ---------------------------------------------------------------------------
# C_L: local push/pop — the host manipulates its own ring, no network.
# ---------------------------------------------------------------------------
def push_local(q: DQueue, vals, valid=None) -> Tuple[DQueue, Tensor]:
    """Host-local batched push: vals (n, vw) appended at tail. Zero phases."""
    dev = q.win.data.device
    vals = as_i32(vals, dev)
    n, vw = vals.shape
    valid = as_mask(valid, (n,), dev)
    data = q.win.data
    local = data[q.host]
    L = q.win.local_size
    tail, head_ready = local[TAIL], local[HEAD_READY]
    ticket = tail + torch.cumsum(valid.to(torch.int32), 0) - 1
    ok = valid & (ticket - head_ready < q.capacity)
    base = CTRL_WORDS + (ticket % q.capacity) * q.slot_w
    cols = base[:, None] + torch.arange(vw, device=dev)
    local = intops.set_drop(local[None],
                            torch.where(ok[:, None], cols, L)[None],
                            vals[None])[0]
    if q.checksum:
        local = intops.set_drop(local[None],
                                torch.where(ok, base + vw, L)[None],
                                _csum(vals)[None])[0]
    new_tail = (tail + ok.sum()).to(torch.int32)
    local[TAIL] = new_tail
    local[TAIL_READY] = new_tail
    data = data.clone()
    data[q.host] = local
    return _with_win(q, Window(data=data)), ok


def pop_local(q: DQueue, n: int) -> Tuple[DQueue, Tensor, Tensor]:
    """Host-local batched pop of up to n values. Zero network phases."""
    dev = q.win.data.device
    data = q.win.data
    local = data[q.host]
    head, tail_ready = local[HEAD], local[TAIL_READY]
    ticket = head + torch.arange(n, dtype=torch.int32, device=dev)
    got = ticket < tail_ready
    base = CTRL_WORDS + (ticket % q.capacity) * q.slot_w
    cols = base[:, None] + torch.arange(q.val_words, device=dev)
    vals = intops.get_fill(local[None], cols[None])[0]
    vals = torch.where(got[:, None], vals, 0)
    new_head = (head + got.sum()).to(torch.int32)
    data = data.clone()
    data[q.host, HEAD] = new_head
    data[q.host, HEAD_READY] = new_head
    return _with_win(q, Window(data=data)), got, vals


# ---------------------------------------------------------------------------
# Transactional composite: atomic pop -> hash-table insert
# ---------------------------------------------------------------------------
def pop_then_insert(q: DQueue, ht, engine, arm: str = "rdma_fused",
                    valid=None, max_probes: int = 8,
                    max_retries: Optional[int] = None):
    """Each participating rank atomically pops ONE item from the hosted
    queue and inserts it into the hash table keyed by its first payload
    word, the cross-structure composite of the multi-space transaction
    engine (`engine`, a core/txn.TxnEngine).

    Staging: every pending rank snapshots (HEAD = h, the slot's payload v)
    and guards the same hot HEAD word with a chain-CAS(h -> h+1), plus the
    HEAD_READY release frontier, the slot's value words and the table's
    claim CAS (flag EMPTY -> READY); then puts land key = v[0] and the
    payload. One rank a round wins the head word (the serialized lock
    phase hands it to the lowest stager); every loser aborts cleanly and
    retries against a fresh snapshot. TAIL_READY is deliberately not
    guarded: a concurrent transactional push extends the readable region
    without invalidating a pop of an older slot.

    Assumes txn-only pops (HEAD and HEAD_READY advance together), a queue
    without checksums, and q.val_words == ht.val_words. A head item whose
    key already sits in the table (or whose probe window is full) stalls
    the composite: it stays at the head and the remaining ranks give up.
    Each attempt reads the two control words, the head slot and the key's
    probe window from the card, nothing more.

    Returns (q', ht', popped (P,) bool, vals (P, val_words) int32)."""
    import numpy as np

    from . import hashtable as ht_mod
    from . import txn as txn_mod
    from .types import FLAG_EMPTY, FLAG_READY, to_host
    P, vw = q.nranks, q.val_words
    if q.checksum:
        raise ValueError("pop_then_insert needs a queue without checksums")
    if vw != ht.val_words:
        raise ValueError("queue payload must match the table's record")
    pending = (np.ones(P, dtype=bool) if valid is None
               else np.asarray(to_host(valid), bool).copy())
    popped = np.zeros(P, dtype=bool)
    out_vals = np.zeros((P, vw), dtype=np.int32)
    wins = {"q": q.win, "ht": ht.win}
    if max_retries is None:
        max_retries = 2 * P + 8
    for _ in range(max_retries):
        if not pending.any():
            break
        host_row = wins["q"].data[q.host]
        h, tr = (int(x) for x in to_host(host_row[[HEAD, TAIL_READY]]))
        if h >= tr:
            break  # queue drained: remaining ranks fail
        base = CTRL_WORDS + (h % q.capacity) * q.slot_w
        v = to_host(host_row[base: base + vw]).astype(np.int32)
        key = int(v[0])
        o2, f2, e2 = ht_mod._probe_np(wins["ht"].data, P, ht.nslots,
                                      ht.rec_w, key, max_probes)
        if f2 >= 0 or e2 < 0:
            break  # head item uninsertable: the composite cannot progress
        off2 = e2 * ht.rec_w
        t = txn_mod.Txn(P)
        t.cas(q.host, HEAD, h, h + 1, space="q", chain=True, valid=pending)
        t.cas(q.host, HEAD_READY, h, h + 1, space="q", chain=True,
              valid=pending)
        for w in range(vw):
            t.cas(q.host, base + w, int(v[w]), int(v[w]), space="q",
                  chain=True, valid=pending)
        t.cas(o2, off2, FLAG_EMPTY, FLAG_READY, space="ht", chain=True,
              valid=pending)
        t.put(o2, off2 + 1, key, space="ht", valid=pending)
        for w in range(vw):
            t.put(o2, off2 + 2 + w, int(v[w]), space="ht", valid=pending)
        res = engine.run(wins, t, arm=arm)
        wins = res.wins
        won = pending & res.committed & res.chain_ok
        popped |= won
        out_vals[won] = v
        pending &= ~won  # losers chain-aborted: fresh snapshot next round
    q2 = _with_win(q, wins["q"])
    ht2 = ht_mod.DHashTable(win=wins["ht"], nslots=ht.nslots, val_words=vw)
    return q2, ht2, popped, out_vals


# ---------------------------------------------------------------------------
# RPC backend (paper Fig. 2 applied to the queue)
# ---------------------------------------------------------------------------
def build_am_handlers(q: DQueue, engine: am_mod.AMEngine):
    """push/pop handlers at the host: bounds checks, wraparound and publish
    in ONE round trip. The sequential per-request semantics are reproduced
    with prefix-rank tickets (a failed op never consumes a ticket, and
    capacity failures are a contiguous suffix of the valid ops), so each
    owner services its whole request list in one vector step."""
    vw, slot_w, cap = q.val_words, q.slot_w, q.capacity

    def push_batched(data, payload, mask):
        L = data.shape[1]
        tail = data[:, TAIL:TAIL + 1]
        head_ready = data[:, HEAD_READY:HEAD_READY + 1]
        ticket = tail + torch.cumsum(mask.to(torch.int32), 1) - 1
        can = mask & (ticket - head_ready < cap)
        base = CTRL_WORDS + (ticket % cap) * slot_w
        cols = base[..., None] + torch.arange(vw, device=data.device)
        data = intops.set_drop(data, torch.where(can[..., None], cols, L),
                               payload[..., :vw])
        if q.checksum:
            data = intops.set_drop(data, torch.where(can, base + vw, L),
                                   _csum(payload[..., :vw]))
        adv = can.sum(1).to(torch.int32)
        data[:, TAIL] += adv
        data[:, TAIL_READY] += adv
        return data, can.to(torch.int32)[..., None]

    def pop_batched(data, payload, mask):
        head = data[:, HEAD:HEAD + 1]
        tail_ready = data[:, TAIL_READY:TAIL_READY + 1]
        ticket = head + torch.cumsum(mask.to(torch.int32), 1) - 1
        can = mask & (ticket < tail_ready)
        base = CTRL_WORDS + (ticket % cap) * slot_w
        cols = base[..., None] + torch.arange(vw, device=data.device)
        rec = torch.where(can[..., None], intops.get_fill(data, cols), 0)
        adv = can.sum(1).to(torch.int32)
        data = data.clone()
        data[:, HEAD] += adv
        data[:, HEAD_READY] += adv
        return data, torch.cat([can.to(torch.int32)[..., None], rec], -1)

    push_h = engine.register("q_push", push_batched, reply_width=1)
    pop_h = engine.register("q_pop", pop_batched, reply_width=1 + vw)
    return push_h, pop_h


def push_rpc(q: DQueue, engine: am_mod.AMEngine, vals, valid=None,
             decision=None) -> Tuple[DQueue, Tensor]:
    """Push via ONE AM round trip."""
    dev = q.win.data.device
    vals = as_i32(vals, dev)
    P, n, _ = vals.shape
    dst = _host_dst(q, (P, n))
    data, replies, delivered = engine.dispatch(
        engine.handler("q_push"), q.win.data, dst, vals,
        None if valid is None else as_mask(valid, (P, n), dev),
        decision=decision)
    ok = delivered & (replies[..., 0] > 0)
    return _with_win(q, Window(data=data)), ok


def pop_rpc(q: DQueue, engine: am_mod.AMEngine, n: int, valid=None,
            decision=None) -> Tuple[DQueue, Tensor, Tensor]:
    """Pop up to n values per rank via ONE AM round trip."""
    dev = q.win.data.device
    P = q.nranks
    dst = _host_dst(q, (P, n))
    payload = torch.zeros((P, n, 1), dtype=torch.int32, device=dev)
    data, replies, delivered = engine.dispatch(
        engine.handler("q_pop"), q.win.data, dst, payload,
        None if valid is None else as_mask(valid, (P, n), dev),
        decision=decision)
    got = delivered & (replies[..., 0] > 0)
    vals = torch.where(got[..., None], replies[..., 1:], 0)
    return _with_win(q, Window(data=data)), got, vals


# ---------------------------------------------------------------------------
# Front doors. The default backend AUTO routes through the adaptive layer
# (core/adaptive.py). C_L short-circuits before any backend decision (zero
# network phases).
# ---------------------------------------------------------------------------
def push(q, vals, *, promise=Promise.CRW, backend=Backend.AUTO, engine=None,
         adaptive=None, **kw):
    """Batched push onto the hosted ring buffer — paper §III-B2.

    vals (P, n, vw) int32 ((n, vw) for C_L); backend "auto" (default),
    "rdma" or "rpc" (with `engine`, which AUTO also uses for its AM arms);
    adaptive: an explicit AdaptiveEngine (default: cached). **kw: valid,
    max_cas_rounds (any backend); stats (AUTO); planned, coalesce (rdma).
    Returns (queue', pushed bool)."""
    if promise == Promise.CL:
        return push_local(q, vals, **kw)
    backend = as_backend(backend)
    if backend == Backend.AUTO:
        from . import adaptive as ad
        a = adaptive or ad.default_engine(q.nranks, am_engine=engine)
        return a.q_push(q, vals, promise=promise, **kw)
    if backend == Backend.RPC:
        return push_rpc(q, engine, vals, valid=kw.get("valid"))
    return push_rdma(q, vals, promise=promise, **kw)


def pop(q, n, *, promise=Promise.CR, backend=Backend.AUTO, engine=None,
        adaptive=None, **kw):
    """Batched pop of up to n values per rank. Backends as in `push`.
    Returns (queue', got (P, n) bool, vals (P, n, vw)), zeros where not got."""
    if promise == Promise.CL:
        return pop_local(q, n)
    backend = as_backend(backend)
    if backend == Backend.AUTO:
        from . import adaptive as ad
        a = adaptive or ad.default_engine(q.nranks, am_engine=engine)
        return a.q_pop(q, n, promise=promise, **kw)
    if backend == Backend.RPC:
        return pop_rpc(q, engine, n, valid=kw.get("valid"))
    return pop_rdma(q, n, promise=promise, **kw)


# ---------------------------------------------------------------------------
# Pipelined (async) front doors: submit through a core/pipeline.Pipeline
# whose state is the DQueue. Submission order is serialization order.
# ---------------------------------------------------------------------------
def _q_async_stats(stats, depth: int):
    from dataclasses import replace as _rep

    from .types import OpStats
    return _rep(stats or OpStats(), pipeline_depth=max(1, int(depth)))


def push_async(pipe, vals, *, promise=Promise.CRW, backend=Backend.AUTO,
               engine=None, adaptive=None, deferred=None, **kw):
    """Submit one push batch to a pipeline; returns a Handle resolving to
    `pushed`; the queue threads through `pipe.state`.

    AM-arm batches wait in the deferred-dispatch queue for the next
    dispatch point (`deferred` overrides; see `hashtable.insert_async`);
    AUTO batches price arms with `stats.pipeline_depth = pipe.depth`. C_L
    pushes are always eager (local compute, nothing to overlap)."""
    backend = as_backend(backend)
    eng = engine if engine is not None else pipe.am_engine
    q0 = pipe.staged_state
    if promise != Promise.CL and backend == Backend.AUTO:
        from . import adaptive as ad
        from .costmodel import DSOp
        a = adaptive or ad.default_engine(q0.nranks, am_engine=eng)
        stats = _q_async_stats(kw.pop("stats", None), pipe.depth)
        stats = a.auto_depth(pipe, DSOp.Q_PUSH, promise,
                             a._host_stats(stats))
        if deferred is None:
            deferred = a.peek_arm(DSOp.Q_PUSH, promise,
                                  a._host_stats(stats)) in ("am", "am_pt")
        kw = dict(kw, stats=stats, adaptive=a)
    elif deferred is None:
        deferred = promise != Promise.CL and backend == Backend.RPC

    def op(q):
        q2, ok = push(q, vals, promise=promise, backend=backend, engine=eng,
                      **kw)
        return q2, ok

    return pipe.submit(op, deferred=deferred, label="q_push")


def pop_async(pipe, n, *, promise=Promise.CR, backend=Backend.AUTO,
              engine=None, adaptive=None, deferred=None, **kw):
    """Submit one pop batch to a pipeline; returns a Handle resolving to
    (got, vals). Staging and deferral as in `push_async`."""
    backend = as_backend(backend)
    eng = engine if engine is not None else pipe.am_engine
    q0 = pipe.staged_state
    if promise != Promise.CL and backend == Backend.AUTO:
        from . import adaptive as ad
        from .costmodel import DSOp
        a = adaptive or ad.default_engine(q0.nranks, am_engine=eng)
        stats = _q_async_stats(kw.pop("stats", None), pipe.depth)
        stats = a.auto_depth(pipe, DSOp.Q_POP, promise,
                             a._host_stats(stats))
        if deferred is None:
            deferred = a.peek_arm(DSOp.Q_POP, promise,
                                  a._host_stats(stats)) in ("am", "am_pt")
        kw = dict(kw, stats=stats, adaptive=a)
    elif deferred is None:
        deferred = promise != Promise.CL and backend == Backend.RPC

    def op(q):
        q2, got, vals = pop(q, n, promise=promise, backend=backend,
                            engine=eng, **kw)
        return q2, (got, vals)

    return pipe.submit(op, deferred=deferred, label="q_pop")
