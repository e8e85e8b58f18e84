"""Edge cases of the owner-list kernels B1 `amo_apply`, B2 `fused_apply`
(`owner_lane_cases`), B9 `txn_group_apply` (`txn_group_apply_cases`) and
B4 `hash_insert` (`hash_insert_cases`), made from
a seed with numpy. The card tests (tests/test_torch_cuda.py) and
chip_smoke.py's phase 1 hold each kernel to its plain version in
kernels/ref.py on them, bit for bit.

They aim at what csrc/owner_lane.cu's design has to get right: it groups
each chunk of live ops by word with a stable sort, scans runs of one
fetch-and-op on a word, walks the rest of each word's chain in list order,
applies chunks in order, and writes B2's overlapping puts in list order.
So: every op on one word (a fetch-and-add hammer the size of the queue's
ticket, mixed codes, a CAS chain), offsets outside [0, L) inside a hot
word's chain, live counts below, at and past a chunk, a long list with few
live rows, an all-masked list, fused winners whose put ranges overlap, and
gathers of words that the puts and publish flips wrote.

B4's design (csrc/hash_probe.cu) groups each chunk of live requests into
components, chains of requests whose probe windows meet on the ring, and
walks each component in list order (`insert_components` mirrors the
grouping on the host). Its cases aim at that: every request on one start
(one long component), windows that wrap past slot nslots - 1 into those
at slot 0, components exactly W and W - 1 slots apart, duplicate keys
inside a component, full windows, starts outside [0, nslots), max_probes
past nslots, shards longer than the records and shorter (clamped slices
share words: one component a chunk), a routed batch with 1.6% live, live
counts past a chunk, and an all-masked list.

The backward kernels B10 `flash_attention_bwd` and B11 `rg_lru_scan_bwd`
take their cases from `FLASH_BWD_CASES` and `RG_LRU_BWD_CASES` (inputs by
`flash_bwd_inputs` / `rg_lru_bwd_inputs`): B10 within
kernels/ref.py's flash_bwd_tol, B11 bit for bit.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

CHUNK = 4096          # live ops in one chunk of the kernels (kChunk)
TICKET_OPS = 16384    # the queue's ticket FAAs at its host, one batch

OP_CAS, OP_FAA = 2, 3
OP_CAS_PUT, OP_CAS_PUT_PUB, OP_FAO_GET = 7, 8, 9


def _mask(rng, m: int, live) -> np.ndarray:
    """(P, m) with live[p] live rows at random positions of row p."""
    mask = np.zeros((len(live), m), bool)
    for p, n in enumerate(live):
        mask[p, rng.choice(m, n, replace=False)] = True
    return mask


def _runs(rng, shape, codes) -> np.ndarray:
    """Op codes drawn in runs of 1-40 of one code along the last axis."""
    P, m = shape
    out = np.empty(shape, np.int32)
    for p in range(P):
        row = []
        while len(row) < m:
            row += [int(rng.choice(codes))] * int(rng.integers(1, 41))
        out[p] = row[:m]
    return out


def _small(rng, shape) -> np.ndarray:
    """Operands in [-3, 3] (CAS compares hit), with INT32_MAX one time in
    ten (int32 wraparound)."""
    x = rng.integers(-3, 4, shape)
    return np.where(rng.random(shape) < 0.1, 2 ** 31 - 1, x)


def _amo(off, code, a, b) -> np.ndarray:
    return np.stack([off, code, a, b], -1).astype(np.int32)


def _fused(off, code, a, b, aux0, aux1, vals) -> np.ndarray:
    head = np.stack([off, code, a, b, aux0, aux1], -1)
    return np.concatenate([head, vals], -1).astype(np.int32)


Case = Tuple[str, str, Tuple[np.ndarray, np.ndarray, np.ndarray], dict]


def owner_lane_cases(seed: int = 0) -> List[Case]:
    """[(label, kernel name, (local, ops, mask), keyword args)], numpy."""
    rng = np.random.default_rng(seed)
    cases: List[Case] = []

    def add(label, local, amo_ops, fused_ops, mask, reply_width):
        cases.append((label, "amo_apply", (local, amo_ops, mask), {}))
        cases.append((label, "fused_apply", (local, fused_ops, mask),
                      {"reply_width": reply_width}))

    # every op on one word: the queue's ticket, 16,384 FAAs at one owner
    # (FAO_GET of kind FAA for B2, gathering the word); the other owner idle
    P, L, m = 2, 64, TICKET_OPS
    local = rng.integers(-9, 9, (P, L)).astype(np.int32)
    mask = _mask(rng, m, [m, 0])
    a = _small(rng, (P, m))
    off = np.full((P, m), 5)
    add("one word: 16384 FAAs", local,
        _amo(off, np.full((P, m), OP_FAA), a, np.zeros((P, m))),
        _fused(off, np.full((P, m), OP_FAO_GET), a, np.full((P, m), OP_FAA),
               np.full((P, m), 5), np.zeros((P, m)), np.zeros((P, m, 1))),
        mask, 2)

    # every op on word 0, in runs of mixed codes (unknown ones too), with
    # offsets in its chain that wrap onto it (-L) or clamp onto it without
    # writing (-L - 1, -2L), and some that clamp onto word L - 1
    P, L, m = 2, 64, 6000
    local = rng.integers(-3, 4, (P, L)).astype(np.int32)
    mask = _mask(rng, m, [m, m - 700])
    off = rng.choice([0, 0, 0, 0, 0, 0, 0, 0, -L, -L - 1, -2 * L, L + 7],
                     (P, m))
    aux0 = rng.integers(-2, L + 2, (P, m))
    add("one word: mixed codes, offsets outside [0, L)", local,
        _amo(off, _runs(rng, (P, m), [0, 1, 2, 3, 4, 5, 6, 9, -1]),
             _small(rng, (P, m)), _small(rng, (P, m))),
        _fused(off, _runs(rng, (P, m), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11]),
               _small(rng, (P, m)), rng.choice([3, 4, 5, 6, 6, 0], (P, m)),
               aux0, rng.integers(-5, 5, (P, m)),
               rng.integers(0, 99, (P, m, 2))),
        mask, 3)

    # a CAS chain on one word: live op k swaps k -> k + 1 (one in twenty
    # expects a wrong value and fails); B2's winners put at aux0 = k mod L,
    # so their ranges overlap in every chunk
    P, L, m = 2, 32, 5000
    local = np.zeros((P, L), np.int32)
    mask = _mask(rng, m, [m - 100, m // 2])
    rank = np.cumsum(mask, 1) - 1
    a = np.where(rng.random((P, m)) < 0.05, -5, rank)
    off = np.full((P, m), 7)
    add("one word: CAS chain", local,
        _amo(off, np.full((P, m), OP_CAS), a, rank + 1),
        _fused(off, rng.choice([OP_CAS_PUT, OP_CAS_PUT_PUB], (P, m)), a,
               rank + 1, (rank % L) - 1, rng.integers(0, 4, (P, m)),
               rng.integers(0, 99, (P, m, 1))),
        mask, 1)

    # live counts below, at and past one chunk, and past two, on 40 words
    live = [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1]
    P, L, m = 4, 256, 9000
    local = rng.integers(-3, 4, (P, L)).astype(np.int32)
    mask = _mask(rng, m, live)
    off = rng.integers(0, 40, (P, m))
    add("live counts at the chunk", local,
        _amo(off, _runs(rng, (P, m), range(7)), _small(rng, (P, m)),
             _small(rng, (P, m))),
        _fused(off, _runs(rng, (P, m), range(10)), _small(rng, (P, m)),
               rng.choice([3, 4, 5, 6], (P, m)),
               rng.integers(0, L - 1, (P, m)), rng.integers(-5, 5, (P, m)),
               rng.integers(0, 99, (P, m, 2))),
        mask, 2)

    # a long list with 1.6% live, as a routed hash-table batch is: claims of
    # random records [flag|key|val] (CAS 0 -> 1 on the flag, publish flip
    # to 2, the key and value put after the flag: disjoint ranges)
    P, nslots, m = 4, 8192, 65536
    L = 3 * nslots
    local = np.zeros((P, L), np.int32)
    local[:, 0::3] = np.where(rng.random((P, nslots)) < 0.25, 2, 0)
    mask = _mask(rng, m, [1049, 1100, 980, 1024])
    flag = 3 * rng.integers(0, nslots, (P, m))
    code = rng.choice([OP_CAS_PUT, OP_CAS_PUT_PUB], (P, m))
    add("m = 65536, 1.6% live", local,
        _amo(flag, rng.choice([OP_CAS, OP_FAA], (P, m)),
             rng.integers(0, 2, (P, m)), np.ones((P, m))),
        _fused(flag, code, np.zeros((P, m)), np.ones((P, m)), flag + 1,
               np.full((P, m), 3), rng.integers(0, 2 ** 31, (P, m, 2))),
        mask, 1)

    # nothing live
    P, L, m = 3, 64, CHUNK
    local = rng.integers(-3, 4, (P, L)).astype(np.int32)
    mask = np.zeros((P, m), bool)
    off = rng.integers(0, L, (P, m))
    add("all rows masked", local,
        _amo(off, rng.integers(0, 7, (P, m)), _small(rng, (P, m)),
             _small(rng, (P, m))),
        _fused(off, rng.integers(0, 10, (P, m)), _small(rng, (P, m)),
               rng.integers(3, 7, (P, m)), rng.integers(0, L, (P, m)),
               rng.integers(-5, 5, (P, m)), rng.integers(0, 99, (P, m, 3))),
        mask, 4)

    # B2, V = 3: claims on 40 flags whose winners put at aux0 in [40, 60]
    # (overlapping ranges), FAO_GETs gathering 3 words anywhere in [0, 62]
    # (words the puts and the publish flips wrote), a few primitive ops
    P, L, m = 2, 128, 700
    local = rng.integers(0, 3, (P, L)).astype(np.int32)
    mask = _mask(rng, m, [m - 50, m])
    code = rng.choice([OP_CAS_PUT, OP_CAS_PUT_PUB, OP_CAS_PUT_PUB,
                       OP_FAO_GET, OP_FAO_GET, OP_FAA, OP_CAS], (P, m))
    get = code == OP_FAO_GET
    cases.append(("fused: overlapping puts, gathers of written words",
                  "fused_apply", (local, _fused(
                      rng.integers(0, 40, (P, m)), code,
                      rng.integers(0, 3, (P, m)),
                      np.where(get, rng.choice([3, 4, 6], (P, m)),
                               rng.integers(0, 3, (P, m))),
                      np.where(get, rng.integers(0, 63, (P, m)),
                               rng.integers(40, 61, (P, m))),
                      rng.integers(1, 8, (P, m)),
                      rng.integers(100, 999, (P, m, 3))), mask),
                  {"reply_width": 4}))
    return cases


# ---------------------------------------------------------------------------
# B9 txn_group_apply
# ---------------------------------------------------------------------------
OP_PUT, OP_GET, OP_FXOR = 0, 1, 6
TXN_ROWS = 1024       # rows the kernel stages in shared memory (kRows)


def _txn(off, code, a, b, gid, chain) -> np.ndarray:
    return np.stack([off, code, a, b, gid, chain], -1).astype(np.int32)


def _txn_random(rng, P: int, L: int, ngroups: int, per: int, span: int,
                chain_p: float, live_p: float):
    """(local, ops, mask) laid out as a commit phase is at its owners: each
    owner's list holds `per` rows of each group in turn (the (src, slot)
    order), on words [0, span), every code 0-6 and an unknown one, chain
    guards on some rows (on CAS rows and others), some rows masked."""
    m = ngroups * per
    local = rng.integers(-4, 4, (P, L)).astype(np.int32)
    gid = np.broadcast_to(np.repeat(np.arange(ngroups), per), (P, m))
    code = rng.choice([0, 1, 2, 2, 2, 3, 4, 5, 6, 11], (P, m))
    ops = _txn(rng.integers(0, span, (P, m)), code, _small(rng, (P, m)),
               _small(rng, (P, m)), gid, rng.random((P, m)) < chain_p)
    return local, ops, rng.random((P, m)) < live_p


def txn_group_apply_cases(seed: int = 0) -> List[Case]:
    """[(label, "txn_group_apply", (local, ops, mask), {"ngroups": G})],
    numpy. The cases aim at what csrc/txn_lane.cu's walk has to get right:
    the undo log of a group's current run (a group split into two runs
    with its guard failing in the second; a failing guard after earlier
    writes of the same word, its own and another group's), the dead flags
    (rows after the failure, `gid` outside [0, ngroups) clipped onto the
    first and last group), what a guard is (chain != 0 on rows that are
    not CAS), an all-masked owner, offsets outside [0, L) written and
    undone, and lists longer than the rows staged at once."""
    rng = np.random.default_rng(seed)
    cases: List[Case] = []

    def add(label, local, ops, mask, ngroups):
        cases.append((label, "txn_group_apply",
                      (np.asarray(local, np.int32), ops,
                       np.asarray(mask, bool)), {"ngroups": ngroups}))

    # group 0 in two runs around group 1's; its guard fails in the second
    # run (owner 0) or the first (owner 1), after writes in both runs; on
    # owner 0 a guard of group 1 after it holds only if the undo stopped
    # at the run's start (word 5 keeps group 1's 7)
    L = 16
    local = np.arange(2 * L, dtype=np.int32).reshape(2, L)
    rows0 = [[3, OP_PUT, 0, 50, 0, 0], [4, OP_FAA, 5, 0, 0, 0],
             [3, OP_FAA, 1, 0, 1, 0], [5, OP_PUT, 0, 7, 1, 0],
             [4, OP_PUT, 0, 60, 0, 0], [5, OP_CAS, -1, 9, 0, 1],
             [5, OP_CAS, 7, 8, 1, 1]]
    rows1 = [[3, OP_PUT, 0, 50, 0, 0], [3, OP_CAS, 0, 9, 0, 1],
             [3, OP_FAA, 1, 0, 1, 0], [4, OP_PUT, 0, 70, 0, 0],
             [4, OP_FAA, 1, 0, 1, 0], [5, OP_GET, 0, 0, 0, 0],
             [6, OP_FAA, 2, 0, 1, 0]]
    add("a group split into two runs", local,
        np.array([rows0, rows1], np.int32), np.ones((2, 7), bool), 2)

    # a failing guard after earlier writes to the word it guards: the group
    # puts, adds and xors word 2, then guards it with a stale compare; the
    # next group reads and adds to it
    local = np.full((2, 8), 4, np.int32)
    rows = [[2, OP_PUT, 0, 11, 0, 0], [2, OP_FAA, 3, 0, 0, 0],
            [2, OP_FXOR, 6, 0, 0, 0], [2, OP_CAS, 11, 1, 0, 1],
            [2, OP_FAA, 1, 0, 0, 0], [2, OP_GET, 0, 0, 1, 0],
            [2, OP_FAA, 5, 0, 1, 0], [2, OP_CAS, 9, 3, 1, 1]]
    ops = np.array([rows, rows], np.int32)
    ops[1, 3, 2] = 8      # owner 1: the guard holds (11 + 3 ^ 6 = 8)
    add("a failing guard after writes to its word", local, ops,
        np.ones((2, 8), bool), 2)

    # gid outside [0, ngroups): clipped, so -3 joins group 0's run and 7
    # and 4 join group 2's (a failure there kills the rows of all three)
    local = rng.integers(-3, 4, (2, 12)).astype(np.int32)
    rows = [[1, OP_PUT, 0, 5, -3, 0], [2, OP_FAA, 1, 0, 0, 0],
            [1, OP_CAS, 5, 6, 1, 1], [3, OP_PUT, 0, 8, 7, 0],
            [3, OP_FAA, 1, 0, 2, 0], [3, OP_CAS, 99, 0, 4, 1],
            [4, OP_PUT, 0, 1, 1, 0]]
    ops = np.array([rows, rows], np.int32)
    ops[1, 5, 2] = 9      # owner 1: the clipped group's guard holds
    add("gid >= ngroups and < 0", local, ops, np.ones((2, 7), bool), 3)

    # chain != 0 on rows that are not CAS: no guard, whatever their value
    local = rng.integers(-3, 4, (2, 8)).astype(np.int32)
    rows = [[0, OP_FAA, 3, 0, 0, 1], [1, OP_PUT, 0, 4, 0, 5],
            [2, OP_GET, 0, 0, 0, 1], [0, OP_FXOR, 7, 0, 1, -1],
            [0, OP_CAS, 99, 1, 1, 0], [1, 11, 2, 3, 1, 1]]
    add("chain != 0 on rows that are not CAS", local,
        np.array([rows, rows], np.int32), np.array([[1] * 6, [1, 0] * 3],
                                                   bool), 2)

    # an all-masked owner beside two busy ones
    local, ops, _ = _txn_random(rng, 3, 24, 4, 5, 24, 0.3, 1.0)
    mask = rng.random((3, 20)) < 0.8
    mask[1] = False
    add("an all-masked owner", local, ops, mask, 4)

    # offsets outside [0, L): negative ones wrap onto the shard once (and
    # are written and undone there), the rest read a clamped word and write
    # nothing
    P, L, ng, per = 2, 16, 4, 6
    local, ops, mask = _txn_random(rng, P, L, ng, per, L, 0.35, 0.9)
    ops[..., 0] = np.where(rng.random((P, ng * per)) < 0.4,
                           rng.choice([-L - 3, -2 * L, -L, -2, -1, L, L + 5],
                                      (P, ng * per)), ops[..., 0])
    add("offsets outside [0, L)", local, ops, mask, ng)

    # a commit phase of 64 ranks: 4 rows each, hot words, every owner
    local, ops, mask = _txn_random(rng, 8, 64, 64, 4, 24, 0.3, 0.6)
    add("64 groups of 4 rows on 24 words", local, ops, mask, 64)

    # lists longer than the staged rows: runs crossing each staging chunk
    local, ops, mask = _txn_random(rng, 3, 128, 7, 500, 40, 0.02, 0.9)
    assert ops.shape[1] > 3 * TXN_ROWS
    add("3500 rows: runs across staging chunks", local, ops, mask, 7)
    return cases


# ---------------------------------------------------------------------------
# B4 hash_insert
# ---------------------------------------------------------------------------
EMPTY, CLAIMED, READY = 0, 1, 2


def insert_components(starts: np.ndarray, mask: np.ndarray, *, nslots: int,
                      rec_w: int, L: int, max_probes: int,
                      chunk: int = CHUNK) -> List[np.ndarray]:
    """The components csrc/hash_probe.cu's insert walks, owner by owner and
    chunk by chunk of the live list: each an array of rows in list order.
    A request's window is [s0, s0 + W) on the ring, s0 = start mod nslots,
    W = min(max_probes, nslots); sorted by s0, a component begins at a gap
    >= W, and the last joins the first where their windows meet past slot
    nslots - 1. Where records alias (nslots * rec_w > L) a chunk is one
    component."""
    W = max(0, min(max_probes, nslots))
    comps: List[np.ndarray] = []
    for p in range(mask.shape[0]):
        live = np.flatnonzero(mask[p])
        for c0 in range(0, len(live), chunk):
            rows = live[c0:c0 + chunk]
            if nslots * rec_w > L:
                comps.append(rows)
                continue
            s0 = np.mod(starts[p, rows].astype(np.int64), nslots)
            order = np.argsort(s0, kind="stable")
            gap = np.diff(s0[order])
            comp = np.empty(len(rows), np.int64)
            comp[order] = np.cumsum(np.concatenate([[True], gap >= W])) - 1
            last = comp.max()
            if last > 0 and s0.min() + nslots - s0.max() < W:
                comp[comp == last] = 0
            comps += [rows[comp == c] for c in np.unique(comp)]
    return comps


def _table(rng, P: int, nslots: int, rec_w: int, L: int, fill: float,
           key_span: int) -> np.ndarray:
    """(P, L) int32: a share `fill` of the nslots records taken (READY
    mostly, some CLAIMED; high flag bytes set on some), keys below
    key_span, words past nslots * rec_w random."""
    flat = rng.integers(-9, 99, (P, L)).astype(np.int64)
    n = min(nslots, L // rec_w)
    rec = np.zeros((P, n, rec_w), np.int64)
    taken = rng.random((P, n)) < fill
    state = np.where(taken, rng.choice([READY, READY, READY, CLAIMED],
                                       (P, n)), EMPTY)
    rec[..., 0] = state + 256 * rng.integers(0, 3, (P, n)) * taken
    rec[..., 1] = rng.integers(0, key_span, (P, n))
    rec[..., 2:] = rng.integers(-99, 99, (P, n, rec_w - 2))
    flat[:, :n * rec_w] = rec.reshape(P, -1)
    return flat.astype(np.int32)


InsertCase = Tuple[str, str, Tuple[np.ndarray, ...], dict]


def hash_insert_cases(seed: int = 0) -> List[InsertCase]:
    """[(label, "hash_insert", (table, starts, keys, vals, mask), keyword
    args)], numpy."""
    rng = np.random.default_rng(seed + 1)
    cases: List[InsertCase] = []

    def add(label, table, starts, keys, vals, mask, nslots, rec_w,
            max_probes=8):
        cases.append((label, "hash_insert", (
            table, np.asarray(starts).astype(np.int32),
            np.asarray(keys).astype(np.int32),
            np.asarray(vals).astype(np.int32), np.asarray(mask, bool)),
            {"nslots": nslots, "rec_w": rec_w, "max_probes": max_probes}))

    # every live request on one start: one component as long as the list,
    # keys from a small set (assignments) and the window filling up
    P, nslots, rec_w, m = 2, 64, 3, 600
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.2, 40)
    mask = _mask(rng, m, [m, 300])
    add("one start: 600 requests", table, np.full((P, m), 10),
        rng.integers(0, 40, (P, m)), rng.integers(0, 99, (P, m, 1)), mask,
        nslots, rec_w)

    # windows past slot nslots - 1: on each owner the last slots are taken,
    # requests there wrap onto slots 0.. and come first in the list; later
    # requests start at 0 and 1 and must see them (first and last
    # components merge); the rest land elsewhere
    P, nslots, rec_w, m = 8, 256, 3, 40
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.0, 1)
    rec = table.reshape(P, nslots, rec_w)
    rec[:, nslots - 3:, 0] = READY
    rec[:, nslots - 3:, 1] = 1000 + np.arange(3)
    wrap = [nslots - 3, nslots - 2, 0, 1, nslots - 1, 0, nslots - 5, 2]
    starts = np.concatenate([np.tile(wrap, (P, 1)),
                             rng.integers(20, 200, (P, m - len(wrap)))], 1)
    keys = np.stack([rng.permutation(500)[:m] for _ in range(P)])
    add("ring wrap: last and first components merge", table, starts, keys,
        rng.integers(0, 99, (P, m, 1)), np.ones((P, m), bool), nslots,
        rec_w)

    # components exactly W apart (windows touch, do not meet) and W - 1
    # apart (they share one slot): slots z..z+6 taken, so the first request
    # at z reaches z + 7 on its last probe, where a later request at z + 7
    # starts
    P, nslots, rec_w, m, z = 8, 512, 4, 24, 100
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.0, 1)
    rec = table.reshape(P, nslots, rec_w)
    rec[:, z:z + 7, 0] = READY
    rec[:, z:z + 7, 1] = 5000 + np.arange(7)
    rec[:, 300:308, 0] = READY
    rec[:, 300:308, 1] = 6000 + np.arange(8)
    pattern = [z, z + 7, z, z + 7, 300, 308, 300, 308]
    starts = np.concatenate([np.tile(pattern, (P, 1)),
                             rng.integers(400, 500, (P, m - len(pattern)))],
                            1)
    keys = np.stack([rng.permutation(1000)[:m] for _ in range(P)])
    add("components W - 1 and W apart", table, starts, keys,
        rng.integers(0, 99, (P, m, 2)), np.ones((P, m), bool), nslots,
        rec_w)

    # duplicate keys inside one component (the last writer's value wins),
    # keys already in the table (assigned), and full windows: a run of 12
    # taken slots where requests probe max_probes slots and fail
    P, nslots, rec_w, m = 3, 128, 3, 200
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.3, 16)
    rec = table.reshape(P, nslots, rec_w)
    rec[:, 60:72, 0] = READY + 512
    rec[:, 60:72, 1] = 900 + np.arange(12)
    starts = np.where(rng.random((P, m)) < 0.5, rng.integers(60, 64, (P, m)),
                      rng.integers(0, 12, (P, m)))
    keys = np.where(rng.random((P, m)) < 0.3, rng.integers(900, 912, (P, m)),
                    rng.integers(0, 16, (P, m)))
    add("duplicate keys in a component, full windows", table, starts, keys,
        rng.integers(0, 99, (P, m, 1)), _mask(rng, m, [m, m - 40, 150]),
        nslots, rec_w)

    # starts outside [0, nslots): negative, past the end, int32 extremes
    P, nslots, rec_w, m = 4, 64, 3, 300
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.3, 30)
    starts = rng.choice([-1, -nslots, -nslots - 3, nslots, nslots + 1,
                         3 * nslots + 5, -2 ** 31, 2 ** 31 - 1, 7, 30],
                        (P, m)) + rng.integers(0, 3, (P, m))
    starts = np.clip(starts, -2 ** 31, 2 ** 31 - 1)
    add("starts outside [0, nslots)", table, starts,
        rng.integers(0, 30, (P, m)), rng.integers(0, 99, (P, m, 1)),
        _mask(rng, m, [m, 200, 100, 1]), nslots, rec_w)

    # max_probes past nslots: every window is the whole ring (one
    # component), and a full ring is probed round more than once
    P, nslots, rec_w, m = 3, 8, 3, 40
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.5, 12)
    add("max_probes >= nslots", table, rng.integers(-20, 20, (P, m)),
        rng.integers(0, 12, (P, m)), rng.integers(0, 99, (P, m, 1)),
        _mask(rng, m, [m, 30, 5]), nslots, rec_w, max_probes=12)

    # shard longer than its records: the words past nslots * rec_w stay
    P, nslots, rec_w, m = 3, 96, 4, 256
    L = nslots * rec_w + 37
    add("L > nslots * rec_w", _table(rng, P, nslots, rec_w, L, 0.3, 20),
        rng.integers(0, 2 * nslots, (P, m)), rng.integers(0, 20, (P, m)),
        rng.integers(0, 99, (P, m, 2)), _mask(rng, m, [200] * 3), nslots,
        rec_w)

    # shard shorter than its records: slots past (L - rec_w) / rec_w read
    # and write the clamped tail, so records share words
    P, nslots, rec_w, m = 3, 96, 3, 256
    L = 200
    add("L < nslots * rec_w (clamped)",
        _table(rng, P, nslots, rec_w, L, 0.3, 20),
        rng.integers(40, nslots, (P, m)), rng.integers(0, 20, (P, m)),
        rng.integers(0, 99, (P, m, 1)), _mask(rng, m, [200] * 3), nslots,
        rec_w)

    # a routed batch at slice shape with 1.6% live: 2**14 slots at load
    # 0.25, val_words 1, half the keys already present
    P, nslots, rec_w, m = 4, 2 ** 14, 3, 65536
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.25, 2 ** 20)
    mask = _mask(rng, m, [1049, 1100, 980, 1024])
    present = table.reshape(P, nslots, rec_w)[..., 1]
    keys = np.where(rng.random((P, m)) < 0.5,
                    present[np.arange(P)[:, None],
                            rng.integers(0, nslots, (P, m))],
                    rng.integers(2 ** 20, 2 ** 30, (P, m)))
    add("m = 65536, 1.6% live", table, rng.integers(0, nslots, (P, m)),
        keys, rng.integers(0, 2 ** 31 - 1, (P, m, 1)), mask, nslots, rec_w)

    # live counts below, at and past one chunk, and past two; keys repeat
    # across chunks, so a later chunk assigns what an earlier one inserted
    live = [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1]
    P, nslots, rec_w, m = 4, 16384, 3, 9000
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.1, 3000)
    add("live counts at the chunk", table, rng.integers(0, nslots, (P, m)),
        rng.integers(0, 3000, (P, m)), rng.integers(0, 99, (P, m, 1)),
        _mask(rng, m, live), nslots, rec_w)

    # nothing live
    P, nslots, rec_w, m = 3, 64, 3, CHUNK
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.4, 20)
    add("all rows masked", table, rng.integers(0, nslots, (P, m)),
        rng.integers(0, 20, (P, m)), rng.integers(0, 99, (P, m, 1)),
        np.zeros((P, m), bool), nslots, rec_w)
    return cases


# ---------------------------------------------------------------------------
# B3 hash_find
# ---------------------------------------------------------------------------
FIND_GROUP = 16       # slots a lane of csrc/hash_probe.cu's find takes
FIND_WARP = 512       # slots a warp takes


def hash_find_cases(seed: int = 0) -> List[InsertCase]:
    """[(label, "hash_find", (table, starts, keys, mask), keyword args)],
    numpy. They aim at csrc/hash_probe.cu's find: 16 slots a lane read and
    zeroed with 16-byte accesses where a warp's 512 slots are whole, the
    live ones compacted and walked one a lane. So: m not a multiple of 16
    (groups span two owners' rows), vw 1, 2 and 3, no live slot, every
    slot live, live slots only at index 15 of a group and at a row's last
    index (all hits), a full table that never shows EMPTY, windows that
    wrap past slot nslots - 1, starts outside [0, nslots), and a routed
    batch at slice shape with 1.6% live."""
    rng = np.random.default_rng(seed + 2)
    cases: List[InsertCase] = []

    def add(label, table, starts, keys, mask, nslots, rec_w, max_probes=8):
        cases.append((label, "hash_find", (
            table, np.asarray(starts).astype(np.int32),
            np.asarray(keys).astype(np.int32), np.asarray(mask, bool)),
            {"nslots": nslots, "rec_w": rec_w, "max_probes": max_probes}))

    def requests(table, nslots, rec_w, shape):
        """(starts, keys): the key of a record at most two slots past the
        start (mostly hits), a quarter of the keys absent."""
        P = table.shape[0]
        rec = table[:, :nslots * rec_w].reshape(P, nslots, rec_w)
        slot = rng.integers(0, nslots, shape)
        k = rec[np.arange(P)[:, None], slot, 1]
        return (slot - rng.integers(0, 3, shape),
                np.where(rng.random(shape) < 0.25, k + 100000, k))

    # m not a multiple of 16, vw = 1, 2, 3 (a warp's slots cross rows)
    for vw in (1, 2, 3):
        P, nslots, rec_w, m = 5, 64, 2 + vw, 100 + vw
        table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.8, 30)
        add(f"m = {m}, vw = {vw}", table,
            *requests(table, nslots, rec_w, (P, m)), rng.random((P, m)) < 0.7,
            nslots, rec_w)
    # whole warps of 512 slots (16-byte path) and a ragged last warp
    P, nslots, rec_w, m = 3, 256, 4, 700
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.8, 60)
    starts, keys = requests(table, nslots, rec_w, (P, m))
    add("no live slot", table, starts, keys, np.zeros((P, m), bool), nslots,
        rec_w)
    add("every slot live", table, starts, keys, np.ones((P, m), bool),
        nslots, rec_w)
    # live only at index 15 of some groups and at each row's last index,
    # every one a hit (its key sits at its start)
    P, nslots, rec_w, m = 4, 128, 3, 1024
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.9, 10 ** 6)
    rec = table.reshape(P, nslots, rec_w)
    rec[..., 0] = READY
    rec[..., 1] = np.arange(nslots) + 1000 * np.arange(P)[:, None]
    mask = np.zeros((P, m), bool)
    mask[:, 15::FIND_GROUP * 3] = True
    mask[:, m - 1] = True
    starts = rng.integers(0, nslots, (P, m))
    add("live only at index 15 of a group and the row's last", table,
        starts, rec[np.arange(P)[:, None], starts, 1], mask, nslots, rec_w)
    # a full table: no EMPTY record, so misses take every probe
    P, nslots, rec_w, m = 3, 64, 3, 600
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 1.0, 40)
    add("full table, EMPTY never reached", table,
        rng.integers(0, nslots, (P, m)), rng.integers(0, 80, (P, m)),
        rng.random((P, m)) < 0.5, nslots, rec_w)
    # windows past slot nslots - 1: the keys sit at slots 0 and 1 behind a
    # run of taken slots at the end
    P, nslots, rec_w, m = 4, 256, 3, 520
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.0, 1)
    rec = table.reshape(P, nslots, rec_w)
    rec[:, nslots - 4:, 0] = READY
    rec[:, nslots - 4:, 1] = 7000 + np.arange(4)
    rec[:, :2, 0] = READY
    rec[:, :2, 1] = [8000, 8001]
    add("windows wrap past slot nslots - 1", table,
        rng.integers(nslots - 4, nslots, (P, m)),
        rng.choice([8000, 8001, 7003, 9999], (P, m)),
        rng.random((P, m)) < 0.8, nslots, rec_w)
    # starts outside [0, nslots), int32 extremes included
    P, nslots, rec_w, m = 2, 64, 4, 512
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.5, 20)
    starts = np.clip(rng.choice([-1, -nslots - 3, nslots + 1, 3 * nslots,
                                 -2 ** 31, 2 ** 31 - 1, 5], (P, m))
                     + rng.integers(0, 3, (P, m)), -2 ** 31, 2 ** 31 - 1)
    add("starts outside [0, nslots)", table, starts,
        rng.integers(0, 20, (P, m)), rng.random((P, m)) < 0.6, nslots, rec_w)
    # a routed batch at slice shape, 1.6% live, half the keys present
    P, nslots, rec_w, m = 8, 2 ** 14, 3, 65536
    table = _table(rng, P, nslots, rec_w, nslots * rec_w, 0.25, 2 ** 20)
    add("m = 65536, 1.6% live", table,
        *requests(table, nslots, rec_w, (P, m)),
        _mask(rng, m, [1049, 1100, 980, 1024, 0, 3, 2000, 1]), nslots,
        rec_w)
    return cases


# ---------------------------------------------------------------------------
# B7 moe_dispatch
# ---------------------------------------------------------------------------
MoeCase = Tuple[str, str, Tuple[np.ndarray], dict]


def moe_dispatch_cases(seed: int = 0) -> List[MoeCase]:
    """[(label, "moe_dispatch", (ids,), {"n_experts": E})], numpy. They aim
    at csrc/moe_dispatch.cu: tiles of 2,048 ids (kTile) ranked at once,
    each from the sum of the tiles before it; 32-id sub-rounds whose peers
    come from __match_any_sync, or from a shuffle loop where a warp holds
    an id in [-E, 0); the serial kernel up to 6,144 ids (kSerialIds) and
    past 2,048 experts (kMaxExperts); tiles of several rounds where the
    table would grow too long."""
    rng = np.random.default_rng(seed + 3)
    cases: List[MoeCase] = []

    def add(label, ids, E):
        cases.append((label, "moe_dispatch",
                      (np.asarray(ids).astype(np.int32),), {"n_experts": E}))

    t = 2048                                  # kTile
    add("T = 196608 uniform over 64 experts (the deepseek prefill)",
        rng.integers(0, 64, 196608), 64)
    add("every id on one expert, ten tiles", np.full(10 * t + 7, 63), 64)
    # ids outside [0, E) at warp, sub-round and tile edges, each in a warp
    # that also holds in-range ids of the column it wraps onto
    E, T = 64, 3 * t + 100
    ids = rng.integers(0, 8, T)
    edges = [0, 31, 32, 127, 128, t - 1, t, t + 1, 2 * t - 1, 2 * t, T - 1]
    for n, i in enumerate(edges):
        ids[i] = (-E + ids[i ^ 1], E + n, -E - 1 - n, -1)[n % 4]
    add("ids outside [0, E) at warp and tile edges", ids, E)
    # the serial kernel's cut-off (3 t) and a tile's edge past it
    for T in (0, 1, 48, 1024, 1025, 3 * t - 1, 3 * t, 3 * t + 1, 4 * t - 1,
              4 * t):
        ids = rng.integers(0, 64, T)
        if T > 2:
            ids[T // 2] = -64 + int(ids[T // 2 + 1])
        add(f"T = {T}", ids, 64)
    add("E = 1", rng.integers(-2, 3, 8000), 1)
    add("E = 128", rng.integers(-130, 130, 30000), 128)
    # E = kMaxExperts: past 65,536 ids a tile is two rounds
    E = 2048
    add(f"E = {E}, tiles of two rounds",
        rng.integers(-E, E + 3, 65536 + t + 5), E)
    add(f"E = {E}, T = 300", rng.integers(-E, E, 300), E)
    add(f"E = {E + 52} (serial kernel)", rng.integers(-2200, 2200, 3000),
        E + 52)
    return cases


# ---------------------------------------------------------------------------
# B10 flash_attention_bwd and B11 rg_lru_scan_bwd
# ---------------------------------------------------------------------------
# (B, H, Hkv, S, Skv, d, causal, window): 1, 3 and 16 query heads a kv head;
# d 64, 128 and 256; S == Skv and end-aligned S < Skv; windows 0 and
# shorter than S; non-causal; S and Skv off the kernels' 32-row tiles; S >
# Skv (causal rows without a key). Then, for the tensor-core tilings (64-
# and 32-key tiles, 64- and 32-row steps, two warps sharing 16 keys at d =
# 256, kv heads' query heads split into groups on a small grid): S and Skv
# off every tile multiple and off 16; g = 16 with Hkv = 1 at d = 256,
# windowed, over 600 and 1,100 keys (16 and 8 groups on 132 SMs); g = 1 at
# d = 256; B > 1 with Hkv > 1 at d = 64 (a grid of 264 blocks, one group)
# and at d = 128; a non-causal Skv > S.
FLASH_BWD_CASES = [
    (2, 4, 4, 64, 64, 64, True, 0),
    (1, 9, 3, 100, 100, 64, True, 0),
    (1, 6, 2, 40, 97, 128, True, 0),
    (1, 16, 1, 70, 150, 256, True, 48),
    (1, 16, 1, 130, 130, 256, True, 64),
    (1, 8, 2, 96, 160, 128, True, 40),
    (2, 4, 1, 33, 33, 64, False, 0),
    (1, 3, 1, 65, 97, 128, False, 20),
    (1, 2, 1, 12, 5, 64, True, 0),
    (1, 6, 3, 77, 203, 64, True, 0),
    (1, 16, 1, 300, 600, 256, True, 200),
    (1, 16, 1, 256, 1100, 256, True, 300),
    (1, 2, 2, 100, 180, 256, True, 0),
    (4, 6, 3, 300, 1400, 64, True, 0),
    (3, 4, 2, 72, 136, 128, True, 0),
    (2, 8, 2, 40, 300, 128, False, 0),
]
# (B, S, D, h0 given): S = 1 and 5 (one thread a column below S = 8); D
# off a warp; B > 1; h0 given and None; S inside one ring stage (32 steps);
# S wrapping the ring (8 stages) twice and ending mid-stage; S a whole
# number of stages (t = 0 in a full stage, h0 through the ring); D off 32
# and off 4 (4-byte copies) with B > 1; D off 32 with 16-byte copies
RG_LRU_BWD_CASES = [(3, 1, 64, True), (2, 5, 64, True), (2, 37, 50, True),
                    (1, 1000, 33, False), (4, 300, 4096, False),
                    (2, 20, 96, True), (1, 2 * 8 * 32 + 5, 64, True),
                    (2, 256, 64, True), (3, 200, 70, True),
                    (2, 300, 100, False)]


def flash_bwd_inputs(case, seed: int = 0):
    """q, do (B, S, H, d) and k, v (B, Skv, Hkv, d) f32 for a case of
    FLASH_BWD_CASES, unit normal (the model's layout; the kernels read
    them through (B, H, S, d) views)."""
    B, H, Hkv, S, Skv, d, _, _ = case
    rng = np.random.default_rng([seed, S, Skv, d, H])
    q, do = (rng.normal(size=(B, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, Hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def rg_lru_bwd_inputs(case, seed: int = 0):
    """a in [0.7, 1), the forward's input b, h0 (or None) and dh, f32, for
    a case of RG_LRU_BWD_CASES."""
    B, S, D, given_h0 = case
    rng = np.random.default_rng([seed, B, S, D])
    a = rng.uniform(0.7, 1.0, (B, S, D)).astype(np.float32)
    b, dh = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, D)).astype(np.float32) if given_h0 else None
    return a, b, h0, dh
