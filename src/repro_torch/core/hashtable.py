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
                    as_i32, as_mask, to_device, to_host)
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
              coalesce: bool = False, cache=None, return_slot: bool = False,
              max_stale: int = 0):
    """Batched find. Returns (table', found (P,n), vals (P,n,vw)).

    C_R : one bare get per probe (flag+key+val in a single R).
    C_RW: read-lock (FAA +unit), get, unlock (FAA -unit) per probe.

    fused=True (default): one RoutePlan per batch; for C_RW the read-lock
    and record gather fuse into one A_FAO_GET request/reply pair. The probe
    loop stops once every op resolved. coalesce=True: duplicate-key rows
    probe once and the reply fans out.

    cache: an optional core/cache.BucketCache, consulted before planning,
    for the fused CR find only (CRW must reach the owner for its read
    locks). Hits are answered at the origin: an all-hit batch issues no
    exchange and launches nothing, a mixed batch plans only the miss
    subset (`routing.miss_subset_plan`), and the probe loop's results are
    handed back with `cache.note_fill`. Bit for bit, by the version
    protocol. max_stale: the cache's bounded-staleness tolerance (0 is
    exact). Keys as a host array keep the lookup off the card's queue.

    return_slot=True (fused, no cache): also return each row's hit slot
    (-1 for misses), for a caller that manages its own cache."""
    if promise not in (Promise.CRW, Promise.CR):
        raise ValueError(f"find promise must be CRW or CR, not {promise}")
    if return_slot and not (fused and cache is None):
        raise ValueError("return_slot needs fused=True and no cache")
    dev = ht.win.data.device
    look = None
    if cache is not None and fused and promise == Promise.CR:
        look = cache.lookup(keys, valid, max_stale=max_stale)
    keys = as_i32(keys, dev)
    valid = as_mask(valid, keys.shape, dev)
    if look is not None and look.all_hit:
        # every valid row served at the origin: no exchange
        win_mod.log_cache_event("cache_hit", {
            "hits": int(look.hit.sum()), "misses": 0, "all_hit": True})
        return (ht, to_device(look.hit, torch.bool, dev),
                to_device(look.vals, torch.int32, dev))
    dst, start = _place(ht, keys)
    rec_w, nslots, vw = ht.rec_w, ht.nslots, ht.val_words
    eff_valid, hit = valid, None
    if look is not None:
        hit = to_device(look.hit, torch.bool, dev)
        eff_valid = valid & ~hit
    if fused and coalesce:
        plan = routing.miss_subset_plan(dst, start, hit,
                                        match=keys[..., None], valid=valid,
                                        cap=keys.shape[1], role="ht_find")
    elif fused:
        plan = routing.make_plan(dst, eff_valid, cap=keys.shape[1],
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

    win, active = ht.win, eff_valid if fused else valid
    found = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    out = torch.zeros(keys.shape + (vw,), dtype=torch.int32, device=dev)
    # the fill needs each hit's slot to stamp its version
    track = fused and (look is not None or return_slot)
    hslot = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)
    if promise == Promise.CR:
        roles = ("get",)
    else:
        roles = ("fao_get", "fao") if fused else ("fao", "get", "fao")
    with flt.loop_scope(dst, roles):
        for j in range(max_probes):
            # fused: an all-inactive probe is an identity, so stop early
            if fused and not bool(active.any()):
                break
            prev = found
            win, active, found, out = probe_body(j, win, active, found, out)
            if track:
                hslot = torch.where(found & ~prev, (start + j) % nslots,
                                    hslot)
    if look is not None:
        found = found | hit
        out = torch.where(hit[..., None],
                          to_device(look.vals, torch.int32, dev), out)
        cache.note_fill(look, hslot, found, out)
        win_mod.log_cache_event("cache_hit", {
            "hits": int(look.hit.sum()), "misses": int(look.miss.sum())})
    if return_slot:
        return _with_win(ht, win), found, out, hslot
    return _with_win(ht, win), found, out


# ---------------------------------------------------------------------------
# Transactional composite: atomic key relocation
# ---------------------------------------------------------------------------
def _probe_words(data, nranks: int, nslots: int, rec_w: int, keys,
                 max_probes: int, extra: int = 0):
    """The probe windows of `keys` (n,) over a window image `data` (numpy
    or a tensor on any device, read with one gather): (owner (n,), slots
    (n, max_probes), words (n, max_probes, 2 + extra)) with each slot's
    first 2 + extra words [flag, key, ...]."""
    owner, start = place_np(nranks, nslots, np.asarray(keys, np.int32))
    slots = (start[:, None].astype(np.int64)
             + np.arange(max_probes)[None, :]) % nslots
    idx = slots[..., None] * rec_w + np.arange(2 + extra)
    rows = owner[:, None, None]
    if isinstance(data, torch.Tensor):
        dev = data.device
        words = to_host(data[torch.as_tensor(rows, device=dev).long(),
                             torch.as_tensor(idx, device=dev)])
    else:
        words = np.asarray(data)[rows, idx]
    return owner, slots, words


def _probe_walk(key: int, slots, words) -> Tuple[int, int]:
    """(found_slot, empty_slot) of one key's window, -1 for absent:
    RESERVED slots are probed past, the walk ends at the first EMPTY."""
    for j in range(slots.shape[0]):
        state = int(words[j, 0]) & STATE_MASK
        if state == FLAG_READY and int(words[j, 1]) == int(key):
            return int(slots[j]), -1
        if state == FLAG_EMPTY:
            return -1, int(slots[j])
    return -1, -1


def _probe_np(data, nranks: int, nslots: int, rec_w: int, key: int,
              max_probes: int):
    """Host-side probe mirror for txn staging: walk `key`'s probe window
    over a window image. Returns (owner, found_slot, empty_slot) with -1
    for absent. RESERVED (tombstone) slots are probed past, the
    open-addressing delete convention `move` relies on, and the window
    ends at the first EMPTY slot."""
    owner, slots, words = _probe_words(data, nranks, nslots, rec_w, [key],
                                       max_probes)
    found, empty = _probe_walk(key, slots[0], words[0])
    return int(owner[0]), found, empty


def move(ht: DHashTable, k1, k2, engine, arm: str = "rdma_fused",
         valid=None, max_probes: int = 8, max_retries: int = 8):
    """Atomically relocate each rank's record from key k1 to key k2, the
    multi-op composite a one-sided component API cannot express without
    the transaction layer.

    One (k1[p], k2[p]) pair per rank (scalars broadcast), staged as ONE
    transaction per rank on `engine` (a core/txn.TxnEngine): chain guards
    pin k1's slot (flag READY -> RESERVED tombstone, key identity, every
    value word) and claim k2's slot (flag EMPTY -> READY), then puts land
    the key and payload. A failed guard aborts the whole txn, both slots
    untouched, and the rank re-probes against the fresh table for up to
    `max_retries` attempts. Ranks whose k1 is absent or whose k2 already
    exists fail with moved=False. The probes read only the probe windows
    from the table (one gather a key set).

    Returns (table', moved (P,) bool, vals (P, val_words) int32, the
    relocated payloads). The source slot is left RESERVED: finds probe
    past it and it is not reclaimed."""
    from . import txn as txn_mod
    P, vw, rec_w, nslots = ht.nranks, ht.val_words, ht.rec_w, ht.nslots
    k1 = np.ascontiguousarray(np.broadcast_to(np.asarray(k1, np.int32),
                                              (P,)))
    k2 = np.ascontiguousarray(np.broadcast_to(np.asarray(k2, np.int32),
                                              (P,)))
    pending = (np.ones(P, dtype=bool) if valid is None
               else np.asarray(to_host(valid), bool).copy())
    moved = np.zeros(P, dtype=bool)
    out_vals = np.zeros((P, vw), dtype=np.int32)
    win = ht.win
    for _ in range(max_retries):
        if not pending.any():
            break
        ranks = np.nonzero(pending)[0]
        o1w, sl1, w1 = _probe_words(win.data, P, nslots, rec_w, k1[ranks],
                                    max_probes, extra=vw)
        o2w, sl2, w2 = _probe_words(win.data, P, nslots, rec_w, k2[ranks],
                                    max_probes)
        o1 = np.zeros(P, np.int32)
        o2 = np.zeros(P, np.int32)
        s1 = np.full(P, -1, np.int32)
        s2 = np.full(P, -1, np.int32)
        vals = np.zeros((P, vw), np.int32)
        for i, p in enumerate(ranks):
            o1[p], o2[p] = o1w[i], o2w[i]
            f1, _ = _probe_walk(k1[p], sl1[i], w1[i])
            f2, e2 = _probe_walk(k2[p], sl2[i], w2[i])
            if f1 < 0 or f2 >= 0 or e2 < 0:
                continue  # k1 absent / k2 present / no room: final failure
            s1[p], s2[p] = f1, e2
            vals[p] = w1[i, list(sl1[i]).index(f1), 2:2 + vw]
        stage = pending & (s1 >= 0) & (s2 >= 0)
        pending = stage  # unstageable ranks are final failures
        if not stage.any():
            break
        off1 = np.maximum(s1, 0) * rec_w
        off2 = np.maximum(s2, 0) * rec_w
        t = txn_mod.Txn(P)
        t.cas(o1, off1, FLAG_READY, FLAG_RESERVED, chain=True, valid=stage)
        t.cas(o1, off1 + 1, k1, k1, chain=True, valid=stage)
        for w in range(vw):
            t.cas(o1, off1 + 2 + w, vals[:, w], vals[:, w], chain=True,
                  valid=stage)
        t.cas(o2, off2, FLAG_EMPTY, FLAG_READY, chain=True, valid=stage)
        t.put(o2, off2 + 1, k2, valid=stage)
        for w in range(vw):
            t.put(o2, off2 + 2 + w, vals[:, w], valid=stage)
        res = engine.run(win, t, arm=arm)
        win = res.wins[t.spaces[0]]
        won = stage & res.committed & res.chain_ok
        moved |= won
        out_vals[won] = vals[won]
        pending = stage & ~won  # chain-aborted: re-probe and retry
    return _with_win(ht, win), moved, out_vals


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
