"""Distributed hash table (open addressing, linear probing) — paper §III-B1
(port of `repro.core.hashtable`).

Slot layout (int32 words):   [ flag | key | val_0 .. val_{vw-1} ]

flag word: low 8 bits = state (EMPTY/RESERVED/READY); bits 8+ = reader count.

Implementations and their best-case costs (paper Table II):

  insert C_RW (rdma):  probes×A_CAS + W + A_FAO   (claim, write, mark-ready)
  insert C_W  (rdma):  probes×A_CAS + W            (barrier supplies the fence)
  find   C_RW (rdma):  A_FAO + R + A_FAO           (read-lock, get, unlock)
  find   C_R  (rdma):  R                           (bare get of the record)
  insert/find (rpc):   one AM round trip + owner-side probe handler

Ownership: owner = mix(key) % P; probing wraps within the owner's local
table so the RDMA and RPC backends have identical placement semantics.
The RPC insert handler does insert-or-assign; the RDMA insert is
insert-only (CAS can only claim EMPTY slots), the paper's expressivity
argument.

JAX's `while_loop` probe rounds become a Python loop that reads its stop
flag once per round (`.item()`, one host sync per round); `fori_loop`
rounds become plain Python loops. Each loop runs under `faults.loop_scope`,
so a fault plan draws its phases once, as JAX's traced body does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import intops
from ..kernels import ops as kops
from . import am as am_mod
from . import faults as flt
from . import routing
from . import window as win_mod
from .types import (FLAG_EMPTY, FLAG_READY, FLAG_RESERVED, READ_UNIT,
                    STATE_MASK, AmoKind, Backend, Promise, as_backend,
                    as_i32, as_mask, to_host)
from .window import (Window, rdma_cas, rdma_cas_put, rdma_cas_put_publish,
                     rdma_fao, rdma_fao_get, rdma_get, rdma_put)

Tensor = torch.Tensor


def hash_mix(key: Tensor) -> Tensor:
    """Deterministic 32-bit integer mix (xorshift-multiply). Returns the
    uint32 result held in an int64 tensor (torch's uint32 is patchy): every
    step is masked to 32 bits, shifts are logical."""
    k = intops.u32(key)
    k = intops.mul_u32(k ^ (k >> 16), 0x85EBCA6B)
    k = intops.mul_u32(k ^ (k >> 13), 0xC2B2AE35)
    return k ^ (k >> 16)


@dataclass
class DHashTable:
    win: Window
    nslots: int      # local slots per rank
    val_words: int

    @property
    def nranks(self) -> int:
        return self.win.nranks

    @property
    def rec_w(self) -> int:
        return 2 + self.val_words


def make_hashtable(nranks: int, nslots: int, val_words: int,
                   device="cuda") -> DHashTable:
    rec_w = 2 + val_words
    return DHashTable(win=win_mod.make_window(nranks, nslots * rec_w,
                                              device=device),
                      nslots=nslots, val_words=val_words)


def _place(ht: DHashTable, keys: Tensor) -> Tuple[Tensor, Tensor]:
    """(owner, start slot) per key, from the unsigned mix."""
    h = hash_mix(keys)
    owner = (h % ht.nranks).to(torch.int32)
    start = ((h // ht.nranks) % ht.nslots).to(torch.int32)
    return owner, start


def hash_mix_np(keys):
    """Host-side (numpy) mirror of `hash_mix` (the port's own copy)."""
    k = np.asarray(keys).astype(np.uint32)
    k = (k ^ (k >> 16)) * np.uint32(0x85EBCA6B)
    k = (k ^ (k >> 13)) * np.uint32(0xC2B2AE35)
    return k ^ (k >> 16)


def place_np(nranks: int, nslots: int, keys):
    """Host-side (numpy) mirror of `_place`: the same owner/start."""
    h = hash_mix_np(keys)
    owner = (h % np.uint32(nranks)).astype(np.int32)
    start = ((h // np.uint32(nranks)) % np.uint32(nslots)).astype(np.int32)
    return owner, start


def _with_win(ht: DHashTable, win: Window) -> DHashTable:
    return DHashTable(win=win, nslots=ht.nslots, val_words=ht.val_words)


# ---------------------------------------------------------------------------
# RDMA backend
# ---------------------------------------------------------------------------
def insert_rdma(ht: DHashTable, keys, vals, promise: Promise = Promise.CRW,
                valid=None, max_probes: int = 8, fused: bool = True,
                coalesce: bool = False) -> Tuple[DHashTable, Tensor, Tensor]:
    """Batched insert. keys (P, n) int32, vals (P, n, vw) int32.

    Returns (table', success (P,n), probe_count (P,n)). Distinct keys per
    batch assumed (open-addressing insert-only).

    fused=True (default): one RoutePlan per batch + fused
    claim/write(/publish) descriptors, each probe ONE request phase; the
    probe loop stops once every op has claimed (an all-inactive phase is an
    identity). fused=False keeps the per-component phases (probes×A_CAS + W
    [+ A_FAO]) with a fixed trip count; both are bit-exact equivalent.

    coalesce=True: duplicate IDENTICAL [key|val] rows are combined
    sender-side (fused: one CoalescedPlan, a duplicate group claims ONE
    slot; unfused: phase-local and fully bit-exact)."""
    if promise not in (Promise.CRW, Promise.CW):
        raise ValueError(f"insert promise must be CRW or CW, not {promise}")
    dev = ht.win.data.device
    keys = as_i32(keys, dev)
    vals = as_i32(vals, dev)
    valid = as_mask(valid, keys.shape, dev)
    dst, start = _place(ht, keys)
    rec_w, nslots = ht.rec_w, ht.nslots
    claim_to = FLAG_RESERVED if promise == Promise.CRW else FLAG_READY
    payload = torch.cat([keys[..., None], vals], dim=-1)
    claimed = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)
    probes = torch.zeros(keys.shape, dtype=torch.int32, device=dev)
    win, active = ht.win, valid

    if fused:
        if coalesce:
            plan = routing.coalesce_plan(dst, start, match=payload,
                                         valid=valid, cap=keys.shape[1],
                                         role="ht_insert")
            co = plan.co
        else:
            plan = routing.make_plan(dst, valid, cap=keys.shape[1],
                                     role="ht_insert")
            co = None
        flip = FLAG_RESERVED ^ FLAG_READY
        j = 0
        role = "cas_put_pub" if promise == Promise.CRW else "cas_put"
        with flt.loop_scope(dst, (role,)):
            while j < max_probes and bool(active.any()):
                slot = (start + j) % nslots
                off = slot * rec_w
                if promise == Promise.CRW:
                    old, win = rdma_cas_put_publish(
                        win, dst, off, FLAG_EMPTY, claim_to, off + 1,
                        payload, flip, valid=active, plan=plan)
                else:
                    old, win = rdma_cas_put(
                        win, dst, off, FLAG_EMPTY, claim_to, off + 1,
                        payload, valid=active, plan=plan)
                if co is not None:
                    # the duplicate run adopts its representative's outcome
                    old = routing.lead(co, old)
                newly = active & (old == FLAG_EMPTY)
                probes = probes + active.to(torch.int32)
                active = active & ~newly
                j += 1
        return _with_win(ht, win), valid & ~active, probes

    with flt.loop_scope(dst, ("cas",)):
        for j in range(max_probes):
            slot = (start + j) % nslots
            off = slot * rec_w
            # coalesce is phase-local here (fresh runs per probe)
            old, win = rdma_cas(win, dst, off, FLAG_EMPTY, claim_to,
                                valid=active, coalesce=coalesce)
            newly = active & (old == FLAG_EMPTY)
            claimed = torch.where(newly, slot, claimed)
            probes = probes + active.to(torch.int32)
            active = active & ~newly
    success = valid & ~active

    # ONE put phase writes [key | val words] for every claimed op.
    win = rdma_put(win, dst, claimed * rec_w + 1, payload, valid=success)
    if promise == Promise.CRW:
        # Flip RESERVED -> READY without touching reader bits: FXOR(1^2).
        flip = torch.full(keys.shape, FLAG_RESERVED ^ FLAG_READY,
                          dtype=torch.int32, device=dev)
        _, win = rdma_fao(win, dst, claimed * rec_w, flip, AmoKind.FXOR,
                          valid=success)
    return _with_win(ht, win), success, probes


def find_rdma(ht: DHashTable, keys, promise: Promise = Promise.CR,
              valid=None, max_probes: int = 8, fused: bool = True,
              coalesce: bool = False, cache=None):
    """Batched find. Returns (table', found (P,n), vals (P,n,vw)).

    C_R : one bare get per probe (flag+key+val in a single R).
    C_RW: read-lock (FAA +unit), get, unlock (FAA -unit) per probe.

    fused=True (default): one RoutePlan per batch; for C_RW the read-lock
    and record gather fuse into one A_FAO_GET request/reply pair. The probe
    loop stops once every op resolved. coalesce=True: duplicate-key rows
    probe once and the reply fans out. The hot-bucket cache (`cache=`) is
    not ported yet."""
    if promise not in (Promise.CRW, Promise.CR):
        raise ValueError(f"find promise must be CRW or CR, not {promise}")
    if cache is not None:
        raise NotImplementedError("find_rdma(cache=...): the hot-bucket "
                                  "cache tier is not ported yet")
    dev = ht.win.data.device
    keys = as_i32(keys, dev)
    valid = as_mask(valid, keys.shape, dev)
    dst, start = _place(ht, keys)
    rec_w, nslots, vw = ht.rec_w, ht.nslots, ht.val_words
    if fused and coalesce:
        plan = routing.coalesce_plan(dst, start, match=keys[..., None],
                                     valid=valid, cap=keys.shape[1],
                                     role="ht_find")
    elif fused:
        plan = routing.make_plan(dst, valid, cap=keys.shape[1],
                                 role="ht_find")
    else:
        plan = None
    loc_coalesce = coalesce and not fused  # phase-local runs (no plan)

    def probe_body(j, win, active, found, out):
        slot = (start + j) % nslots
        off = slot * rec_w
        if promise == Promise.CRW:
            unit = torch.full(keys.shape, READ_UNIT, dtype=torch.int32,
                              device=dev)
            if fused:
                old, rec, win = rdma_fao_get(
                    win, dst, off, unit, AmoKind.FAA, off, rec_w,
                    valid=active, plan=plan)
                state = old & STATE_MASK
            else:
                old, win = rdma_fao(win, dst, off, unit, AmoKind.FAA,
                                    valid=active, coalesce=loc_coalesce)
                state = old & STATE_MASK
                lockable = active & (state == FLAG_READY)
                rec = rdma_get(win, dst, off, rec_w, valid=lockable,
                               coalesce=loc_coalesce)
            _, win = rdma_fao(win, dst, off, -unit, AmoKind.FAA,
                              valid=active, plan=plan,
                              coalesce=loc_coalesce)
            flag_state = state
        else:
            rec = rdma_get(win, dst, off, rec_w, valid=active, plan=plan,
                           coalesce=loc_coalesce)
            flag_state = rec[..., 0] & STATE_MASK
        hit = active & (flag_state == FLAG_READY) & (rec[..., 1] == keys)
        miss_end = active & (flag_state == FLAG_EMPTY)
        out = torch.where(hit[..., None], rec[..., 2:2 + vw], out)
        return win, active & ~(hit | miss_end), found | hit, out

    win, active = ht.win, valid
    found = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    out = torch.zeros(keys.shape + (vw,), dtype=torch.int32, device=dev)
    if promise == Promise.CR:
        roles = ("get",)
    else:
        roles = ("fao_get", "fao") if fused else ("fao", "get", "fao")
    with flt.loop_scope(dst, roles):
        for j in range(max_probes):
            # fused: an all-inactive probe is an identity, so stop early
            if fused and not bool(active.any()):
                break
            win, active, found, out = probe_body(j, win, active, found, out)
    return _with_win(ht, win), found, out


# ---------------------------------------------------------------------------
# RPC backend (active messages, paper Fig. 2)
# ---------------------------------------------------------------------------
def build_am_handlers(ht: DHashTable, engine: am_mod.AMEngine,
                      max_probes: int = 8):
    """Register insert/find handlers. Handler state = the owners' slot words.

    The insert handler runs each owner's requests sequentially (the
    target-side serial execution of AM handlers); arbitrary control flow
    costs no extra network phases. The bodies go through kernels/ops.py:
    on a CUDA table they launch the hash_insert / hash_find kernels, on a
    CPU table they run the plain versions in kernels/ref.py."""
    nslots, rec_w, vw = ht.nslots, ht.rec_w, ht.val_words

    def insert_body(probe_insert):
        def fn(data, flat, mask):
            # payload (P, m, 2 + vw) = [start | key | val...];
            # reply (P, m, 2) = [ok | probes]
            ok, probes, data2 = probe_insert(
                data, flat[..., 0], flat[..., 1], flat[..., 2:2 + vw], mask,
                nslots=nslots, rec_w=rec_w, max_probes=max_probes)
            return data2, torch.stack([ok.to(torch.int32), probes], dim=-1)
        return fn

    def find_body(probe_find):
        def fn(data, flat, mask):
            # payload (P, m, 2) = [start | key]; reply (P, m, 1 + vw)
            found, vals = probe_find(
                data, flat[..., 0], flat[..., 1], mask,
                nslots=nslots, rec_w=rec_w, max_probes=max_probes)
            return data, torch.cat([found.to(torch.int32)[..., None], vals],
                                   dim=-1)
        return fn

    ins = engine.register("ht_insert", insert_body(kops.hash_insert),
                          reply_width=2)
    fnd = engine.register("ht_find", find_body(kops.hash_find),
                          reply_width=1 + vw)
    return ins, fnd


def insert_rpc(ht: DHashTable, engine: am_mod.AMEngine, keys, vals,
               valid=None, decision=None, coalesce: bool = False
               ) -> Tuple[DHashTable, Tensor, Tensor]:
    """Insert-or-assign via ONE AM round trip.

    Returns (table', ok, probes): probes is the handler's REAL probe count
    carried in the reply word. coalesce=True dedups identical
    [start|key|val] request rows (the handler is idempotent for them)."""
    dev = ht.win.data.device
    keys = as_i32(keys, dev)
    vals = as_i32(vals, dev)
    dst, start = _place(ht, keys)
    payload = torch.cat([start[..., None], keys[..., None], vals], dim=-1)
    h = engine.handler("ht_insert")
    data, replies, delivered = engine.dispatch(
        h, ht.win.data, dst, payload,
        None if valid is None else as_mask(valid, keys.shape, dev),
        decision=decision, coalesce=coalesce)
    ok = delivered & (replies[..., 0] > 0)
    probes = torch.where(delivered, replies[..., 1], 0)
    return _with_win(ht, Window(data=data)), ok, probes


def find_rpc(ht: DHashTable, engine: am_mod.AMEngine, keys, valid=None,
             decision=None, coalesce: bool = False) -> Tuple[Tensor, Tensor]:
    """Find via ONE AM round trip. Returns (found (P, n), vals (P, n, vw))."""
    dev = ht.win.data.device
    keys = as_i32(keys, dev)
    dst, start = _place(ht, keys)
    payload = torch.cat([start[..., None], keys[..., None]], dim=-1)
    h = engine.handler("ht_find")
    _, replies, delivered = engine.dispatch(
        h, ht.win.data, dst, payload,
        None if valid is None else as_mask(valid, keys.shape, dev),
        decision=decision, coalesce=coalesce)
    found = delivered & (replies[..., 0] > 0)
    return found, replies[..., 1:]


# ---------------------------------------------------------------------------
# Front doors. backend accepts Backend or its string value; the default is
# AUTO: the adaptive layer (core/adaptive.py) picks the cheapest arm per
# batch. Without an AMEngine the AUTO choice is between the one-sided arms
# (rdma / rdma_fused).
# ---------------------------------------------------------------------------
def insert(ht, keys, vals, *, promise=Promise.CRW, backend=Backend.AUTO,
           engine=None, adaptive=None, **kw):
    """Batched distributed insert — the paper's §III-B1 op.

    keys (P, n) int32 (distinct per batch for the RDMA arms), vals
    (P, n, vw); backend "auto" (default), "rdma" or "rpc" (with `engine`,
    which AUTO also uses for its AM arms); adaptive: an explicit
    AdaptiveEngine (default: one cached per nranks or per engine).
    **kw: valid, max_probes (any backend); stats (AUTO: the chooser's
    OpStats); fused, coalesce (rdma); coalesce (rpc).
    Returns (table', ok (P, n) bool, probes (P, n) int32)."""
    backend = as_backend(backend)
    if backend == Backend.AUTO:
        from . import adaptive as ad
        a = adaptive or ad.default_engine(ht.nranks, am_engine=engine)
        return a.ht_insert(ht, keys, vals, promise=promise, **kw)
    if backend == Backend.RPC:
        return insert_rpc(ht, engine, keys, vals, valid=kw.get("valid"),
                          coalesce=kw.get("coalesce", False))
    return insert_rdma(ht, keys, vals, promise=promise, **kw)


def find(ht, keys, *, promise=Promise.CR, backend=Backend.AUTO, engine=None,
         adaptive=None, **kw):
    """Batched distributed find. Same backend selection as `insert`.
    Returns (table', found (P, n) bool, vals (P, n, vw) int32), vals zero
    where not found (the table changes only under C_RW reader counts)."""
    backend = as_backend(backend)
    if backend == Backend.AUTO:
        from . import adaptive as ad
        a = adaptive or ad.default_engine(ht.nranks, am_engine=engine)
        return a.ht_find(ht, keys, promise=promise, **kw)
    if backend == Backend.RPC:
        found, vals = find_rpc(ht, engine, keys, valid=kw.get("valid"),
                               coalesce=kw.get("coalesce", False))
        return ht, found, vals
    return find_rdma(ht, keys, promise=promise, **kw)


# ---------------------------------------------------------------------------
# Pipelined (async) front doors: submit through a core/pipeline.Pipeline
# whose state is the DHashTable; return a Handle instead of blocking.
# Forcing at once (depth=1, or result() right after submit) IS the
# synchronous path, bit for bit.
# ---------------------------------------------------------------------------
def _async_stats(ht, keys, valid, stats, depth: int):
    """Fold the batch's skew (owners through `place_np`) and dedup ratio,
    counted on the host, and the pipeline depth into the cost-model
    stats, as the JAX package does, so that staging reads no device value.
    Keys given as a CUDA tensor are copied to the host here, which waits
    for the batches already queued: pass host arrays to keep the overlap."""
    from dataclasses import replace as _rep

    from . import adaptive as ad
    from .types import OpStats
    s = stats or OpStats()
    k, v = to_host(keys), to_host(valid)
    # 1.0 doubles as OpStats' "unknown": nudge a computed 1.0 off it by an
    # epsilon the scores cannot see, so the stage-time decide() does not
    # count it again from a device value
    if s.skew == 1.0:
        owner, _ = place_np(ht.nranks, ht.nslots, k)
        skew = ad.batch_skew(owner, ht.nranks, v)
        s = _rep(s, skew=skew if skew != 1.0 else 1.0 + 1e-9)
    if s.dedup == 1.0:
        # nudged UP: dedup < 1 would turn coalescing on; every consumer
        # clamps at 1.0, so > 1 means "known all-distinct"
        dd = ad.batch_dedup(k, v)
        s = _rep(s, dedup=dd if dd != 1.0 else 1.0 + 1e-9)
    return _rep(s, pipeline_depth=max(1, int(depth)))


def insert_async(pipe, keys, vals, *, promise=Promise.CRW,
                 backend=Backend.AUTO, engine=None, adaptive=None,
                 deferred=None, **kw):
    """Submit one insert batch to a pipeline; returns a `pipeline.Handle`
    resolving to (ok, probes); the table threads through `pipe.state`.

    The batch stages at once (eager) unless its arm is an active message,
    in which case it waits in the deferred-dispatch queue until the next
    dispatch point (`deferred` overrides; default: backend "rpc", or what
    `AdaptiveEngine.peek_arm` says for AUTO). Submission order is
    serialization order, so results equal calling `insert` in the same
    order, with `result()` forced in any order.

    AUTO batches price arms with `stats.pipeline_depth = pipe.depth`, take
    skew and dedup from the keys on the host (`_async_stats`), and under
    `Pipeline(auto_depth=True)` let the chooser retarget the window count
    (`AdaptiveEngine.auto_depth`)."""
    backend = as_backend(backend)
    eng = engine if engine is not None else pipe.am_engine
    st = pipe.staged_state
    if backend == Backend.AUTO:
        from . import adaptive as ad
        from .costmodel import DSOp
        a = adaptive or ad.default_engine(st.nranks, am_engine=eng)
        stats = _async_stats(st, keys, kw.get("valid"), kw.pop("stats", None),
                             pipe.depth)
        stats = a.auto_depth(pipe, DSOp.HT_INSERT, promise, stats)
        if deferred is None:
            deferred = a.peek_arm(DSOp.HT_INSERT, promise,
                                  a._ht_stats(keys, kw.get("valid"), stats)
                                  ) in ("am", "am_pt")
        kw = dict(kw, stats=stats, adaptive=a)
    elif deferred is None:
        deferred = backend == Backend.RPC

    def op(ht):
        ht2, ok, probes = insert(ht, keys, vals, promise=promise,
                                 backend=backend, engine=eng, **kw)
        return ht2, (ok, probes)

    return pipe.submit(op, deferred=deferred, label="ht_insert")


def find_async(pipe, keys, *, promise=Promise.CR, backend=Backend.AUTO,
               engine=None, adaptive=None, deferred=None, **kw):
    """Submit one find batch to a pipeline; returns a Handle resolving to
    (found, vals). Staging and deferral as in `insert_async`."""
    backend = as_backend(backend)
    eng = engine if engine is not None else pipe.am_engine
    st = pipe.staged_state
    if backend == Backend.AUTO:
        from . import adaptive as ad
        from .costmodel import DSOp
        a = adaptive or ad.default_engine(st.nranks, am_engine=eng)
        stats = _async_stats(st, keys, kw.get("valid"), kw.pop("stats", None),
                             pipe.depth)
        stats = a.auto_depth(pipe, DSOp.HT_FIND, promise, stats)
        if deferred is None:
            deferred = a.peek_arm(DSOp.HT_FIND, promise,
                                  a._ht_stats(keys, kw.get("valid"), stats)
                                  ) in ("am", "am_pt")
        kw = dict(kw, stats=stats, adaptive=a)
    elif deferred is None:
        deferred = backend == Backend.RPC

    def op(ht):
        ht2, found, vals = find(ht, keys, promise=promise, backend=backend,
                                engine=eng, **kw)
        return ht2, (found, vals)

    return pipe.submit(op, deferred=deferred, label="ht_find")
