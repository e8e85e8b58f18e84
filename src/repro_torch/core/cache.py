"""Hot-bucket caching tier for the distributed hash table (port of
`repro.core.cache`, DESIGN.md §8).

Zipfian find traffic concentrates on a few hot keys; coalescing collapses
duplicates within a batch, but every batch still pays the round trip.
This tier keeps hot buckets local: each origin rank holds a small cache of
records it fetched before, validated by version tags that are bumped on
the host, with no extra exchange, whenever a write could touch the bucket.

Coherence protocol
------------------
* `versions` is a per-(owner, slot) counter. A cached entry stores the
  version it saw at fill time; a lookup whose stored version no longer
  matches is a stale eviction (counted, entry dropped).
* Writers bump versions through two channels:
  - `on_insert_keys` (authoritative): the structure layer calls it before
    any insert arm runs, the AM insert-or-assign included, and it bumps the
    whole probe window [(start + j) % nslots, j < max_probes] of every
    written key;
  - `on_publish` (precision): publish flips issued outside a probe loop
    (the unfused insert's final FXOR, a transaction's commit) bump the
    exact flipped slot inside `window.cache_scope`. The JAX package traces
    its probe loops, where the offsets are tracers and this channel does
    nothing; the port runs them eagerly under `faults.loop_scope`, and
    `window._notify_publish` stays silent there, so both packages bump the
    same versions and `write_tick`.
* Only positive entries are cached (records found READY with the key).

Deferred fills
--------------
Fill values are device tensors; reading them at fill time would serialize
a pipelined stream. A fill is queued with a snapshot of the global
`write_tick` and, for CUDA tensors, a non-blocking copy into pinned host
buffers and a `torch.cuda.Event` recorded after it. It is applied at the
next drain: at once outside the pipelined engine, and between pipelined
submits only when its event has completed. A fill whose tick no longer
matches raced with a writer and is dropped (a future miss, never a stale
hit); one that survives saw no write, so stamping it with the current
versions is exact.

Storage is per origin and set-associative (`capacity` entries per origin
in `capacity / ways` sets, vectorized numpy). The cache is host state,
shared by reference; it is coherent for writes issued through the owning
`adaptive.AdaptiveEngine` (or a caller that calls `on_insert_keys` before
writing). One cache serves exactly one table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .types import to_host

# Tag sentinel for an empty line. Keys are int32; the tag array is int64 so
# no valid key can collide with the sentinel.
_EMPTY_TAG = np.int64(1) << 40


def _host_async(x):
    """(host array or pinned tensor, event) for a fill value: a CUDA
    tensor starts a non-blocking copy into pinned memory and records an
    event after it; anything else is copied to numpy at once."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return buf, ev
    return to_host(x), None


@dataclass
class CacheLookup:
    """Host-side result of one batch lookup (all numpy)."""

    hit: np.ndarray        # (P, n) bool — fresh positive entry
    vals: np.ndarray       # (P, n, vw) int32 — zeros where miss
    keys: np.ndarray       # (P, n) int32 — the batch keys
    valid: np.ndarray      # (P, n) bool — the valid mask
    tick: int              # write_tick snapshot at lookup time

    @property
    def miss(self) -> np.ndarray:
        return self.valid & ~self.hit

    @property
    def all_hit(self) -> bool:
        return not bool(self.miss.any())

    @property
    def hit_rate(self) -> float:
        nv = int(self.valid.sum())
        return float(self.hit.sum() / nv) if nv else 0.0


class BucketCache:
    """Per-origin set-associative cache of hot hash-table records with
    publish-bumped version tags (see the module docstring)."""

    def __init__(self, nranks: int, nslots: int, val_words: int,
                 capacity: int = 4096, max_probes: int = 8, ways: int = 4):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        if ways & (ways - 1) or not 0 < ways <= capacity:
            raise ValueError("ways must be a power of two <= capacity")
        self.nranks = nranks
        self.nslots = nslots
        self.val_words = val_words
        self.rec_w = 2 + val_words
        self.capacity = capacity
        self.ways = ways
        self.sets = capacity // ways
        self.max_probes = max_probes
        self.enabled = True
        # per-(owner, slot) version counters: the invalidation substrate
        self.versions = np.zeros((nranks, nslots), np.int64)
        # global write counter: deferred-fill race detection
        self.write_tick = 0
        self.epoch = 0                       # invalidate_all generations
        # per-origin (sets, ways) store + round-robin victim clock
        self._tag = np.full((nranks, self.sets, ways), _EMPTY_TAG, np.int64)
        self._owner = np.zeros((nranks, self.sets, ways), np.int32)
        self._slot = np.zeros((nranks, self.sets, ways), np.int32)
        self._ver = np.zeros((nranks, self.sets, ways), np.int64)
        self._val = np.zeros((nranks, self.sets, ways, val_words), np.int32)
        self._clock = np.zeros((nranks, self.sets), np.int64)
        self._pending: List[Tuple] = []
        self.last_hit_rate: Optional[float] = None
        self.counters = {"lookups": 0, "hits": 0, "misses": 0, "fills": 0,
                         "stale_evicted": 0, "invalidations": 0,
                         "fill_drops": 0}

    # -- placement -----------------------------------------------------------
    def _index(self, keys: np.ndarray) -> np.ndarray:
        from .hashtable import hash_mix_np
        return (hash_mix_np(keys) % np.uint32(self.sets)).astype(np.int64)

    def _placement(self, keys: np.ndarray):
        from .hashtable import place_np
        return place_np(self.nranks, self.nslots, keys)

    # -- read path -----------------------------------------------------------
    def lookup(self, keys, valid=None,
               max_stale: int = 0) -> Optional[CacheLookup]:
        """Consult the cache for one (P, n) find batch; None when the
        cache is disabled (callers fall through to the engine). Stale
        entries found here are evicted.

        max_stale: serve entries whose version lags the authoritative one
        by at most this many bumps (0, the default, is bit-exact: any
        mismatch is a miss). Entries lagging further are evicted. Keys
        given as a CUDA tensor are copied to the host, which waits for the
        work already queued: pass host arrays to keep a stream's
        overlap."""
        if not self.enabled:
            return None
        k = to_host(keys)
        v = (np.ones(k.shape, bool) if valid is None
             else to_host(valid).astype(bool))
        self.drain_fills()
        k = k.astype(np.int32)
        P, n = k.shape
        idx = self._index(k)
        pp = np.arange(P)[:, None]
        line_tag = self._tag[pp, idx]                       # (P, n, W)
        tag_hit_w = (line_tag == k.astype(np.int64)[..., None]) \
            & v[..., None]
        owner = self._owner[pp, idx]
        slot = self._slot[pp, idx]
        lag = self.versions[owner, slot] - self._ver[pp, idx]
        fresh = (lag >= 0) & (lag <= int(max_stale))
        hit_w = tag_hit_w & fresh
        stale_w = tag_hit_w & ~fresh
        if stale_w.any():
            rows, cols, wys = np.nonzero(stale_w)
            self._tag[rows, idx[rows, cols], wys] = _EMPTY_TAG
            self.counters["stale_evicted"] += int(rows.size)
        hit = hit_w.any(-1)
        way = np.argmax(hit_w, axis=-1)                     # (P, n)
        vals = np.where(hit[..., None],
                        self._val[pp, idx, way], 0).astype(np.int32)
        nhit, nvalid = int(hit.sum()), int(v.sum())
        self.counters["lookups"] += 1
        self.counters["hits"] += nhit
        self.counters["misses"] += nvalid - nhit
        self.last_hit_rate = nhit / nvalid if nvalid else 0.0
        return CacheLookup(hit=hit, vals=vals, keys=k, valid=v,
                           tick=self.write_tick)

    # -- fill path -----------------------------------------------------------
    def note_fill(self, look: CacheLookup, slot, found, vals) -> None:
        """Queue the probe loop's results for the miss subset: slot (P, n)
        hit slot, found (P, n), vals (P, n, vw), tensors possibly still
        being computed on the card (copied to the host without waiting)."""
        if not look.miss.any():
            return
        host = [_host_async(x) for x in (slot, found, vals)]
        events = [ev for _, ev in host if ev is not None]
        self._pending.append((look.tick, look.keys, look.miss,
                              [h for h, _ in host], events))
        self.drain_fills()

    def drain_fills(self, force: Optional[bool] = None) -> None:
        """Apply the pending fills whose values have reached the host.

        force=None decides by itself: waiting for the values is safe only
        outside the pipelined engine, that is outside a slot scope
        (staging) and while no pipeline holds an in-flight window
        (`window.pipeline_inflight`); there the fills whose copies have
        not completed stay queued, so a drain never serializes the
        overlap. force=True waits (tests, teardown)."""
        if not self._pending:
            return
        if force is None:
            from . import window as win_mod
            force = (win_mod._CURRENT_SLOT is None
                     and not win_mod.pipeline_inflight())
        keep = []
        for rec in self._pending:
            tick, keys, miss, host, events = rec
            if tick != self.write_tick:
                # raced with a writer: the read may predate the write
                self.counters["fill_drops"] += 1
                continue
            if not (force or all(ev.query() for ev in events)):
                keep.append(rec)
                continue
            for ev in events:
                ev.synchronize()
            self._apply_fill(keys, miss, *(to_host(h) for h in host))
        self._pending = keep

    def _apply_fill(self, keys, miss, slot, found, vals) -> None:
        mask = miss & found.astype(bool) & (slot >= 0)
        if not mask.any():
            return
        owner, _ = self._placement(keys)
        rows, cols = np.nonzero(mask)
        idx = self._index(keys)
        ci = idx[rows, cols]
        ow, sl = owner[rows, cols], slot[rows, cols]
        key64 = keys[rows, cols].astype(np.int64)
        fvals = vals[rows, cols]
        # dedupe (origin, key): a key's duplicate rows carry identical
        # records, and distinct per-set entries must get distinct ways
        combo = (rows.astype(np.int64) << 32) | key64
        _, first = np.unique(combo, return_index=True)
        rows, ci, ow, sl = rows[first], ci[first], ow[first], sl[first]
        key64, fvals = key64[first], fvals[first]
        # way choice: the key's existing line if present, else an empty
        # way, else the set's round-robin victim
        line_tags = self._tag[rows, ci]                     # (m, W)
        present = line_tags == key64[:, None]
        empty = line_tags == _EMPTY_TAG
        way = np.where(
            present.any(1), present.argmax(1),
            np.where(empty.any(1), empty.argmax(1),
                     self._clock[rows, ci] % self.ways)).astype(np.int64)
        # distinct keys of one batch landing in one set all saw the
        # pre-fill line, so they can pick the same way; rotate the
        # conflicts onto free ways with a host loop over the sets that
        # have one (a set's choices depend on its own rows only)
        grp = rows * np.int64(self.sets) + ci
        tgt = grp * self.ways + way
        uniq, cnt = np.unique(tgt, return_counts=True)
        if (cnt > 1).any():
            clash = np.isin(grp, uniq[cnt > 1] // self.ways)
            taken: dict = {}
            for i in np.nonzero(clash)[0]:
                used = taken.setdefault((int(rows[i]), int(ci[i])), set())
                w = int(way[i])
                if w in used:
                    pick = None
                    for d in range(1, self.ways):
                        w2 = (w + d) % self.ways
                        if w2 in used:
                            continue
                        if pick is None:
                            pick = w2
                        if empty[i, w2]:
                            pick = w2
                            break
                    if pick is not None:
                        w = pick
                used.add(w)
                way[i] = w
        # no write intervened since the read (tick check), so the current
        # version table is the version the record was read at
        self._tag[rows, ci, way] = key64
        self._owner[rows, ci, way] = ow
        self._slot[rows, ci, way] = sl
        self._ver[rows, ci, way] = self.versions[ow, sl]
        self._val[rows, ci, way] = fvals
        np.add.at(self._clock, (rows, ci), 1)
        self.counters["fills"] += int(rows.size)
        from . import window as win_mod
        win_mod.log_cache_event("cache_fill", {"rows": int(rows.size)})

    # -- write / invalidation path -------------------------------------------
    def on_insert_keys(self, keys, valid=None,
                       max_probes: Optional[int] = None) -> None:
        """Authoritative pre-write invalidation: bump the probe-window
        versions of every key about to be written (any arm, the AM
        insert-or-assign included)."""
        self.write_tick += 1
        k = to_host(keys)
        v = to_host(valid)
        k = k.astype(np.int32).ravel() if v is None else \
            k.astype(np.int32)[v.astype(bool)].ravel()
        if k.size == 0:
            return
        mp = self.max_probes if max_probes is None else max_probes
        owner, start = self._placement(k)
        window_slots = (start[:, None].astype(np.int64)
                        + np.arange(mp)[None, :]) % self.nslots
        np.add.at(self.versions,
                  (np.repeat(owner, mp), window_slots.ravel()), 1)
        self.counters["invalidations"] += int(k.size)
        from . import window as win_mod
        win_mod.log_cache_event("cache_invalidate",
                                {"keys": int(k.size), "probe_window": mp})

    def on_publish(self, dst, off, valid=None) -> None:
        """Precision invalidation from a publish flip: bump exactly the
        flipped slot (off is the flag-word offset, slot = off // rec_w)."""
        d, o = to_host(dst), to_host(off)
        self.write_tick += 1
        if valid is not None:
            sel = to_host(valid).astype(bool)
            d, o = d[sel], o[sel]
        slots = (o.astype(np.int64) // self.rec_w) % self.nslots
        if d.size:
            np.add.at(self.versions, (d.ravel(), slots.ravel()), 1)

    def invalidate_all(self, bump_tick: bool = True) -> None:
        """Drop every entry and pending fill (conservative full flush)."""
        if bump_tick:
            self.write_tick += 1
        self.epoch += 1
        self._tag.fill(_EMPTY_TAG)
        self.counters["fill_drops"] += len(self._pending)
        self._pending.clear()
        from . import window as win_mod
        win_mod.log_cache_event("cache_invalidate", {"all": True})

    # -- introspection -------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        h, m = self.counters["hits"], self.counters["misses"]
        return h / (h + m) if h + m else 0.0

    def stats(self) -> dict:
        return {**self.counters, "hit_rate": self.hit_rate,
                "epoch": self.epoch, "write_tick": self.write_tick,
                "pending_fills": len(self._pending),
                "capacity": self.capacity, "ways": self.ways,
                "entries": int((self._tag != _EMPTY_TAG).sum())}
