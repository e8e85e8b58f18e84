"""Edge cases of the owner-lane kernels B1 `amo_apply` and B2 `fused_apply`,
made from a seed with numpy. The card tests (tests/test_torch_cuda.py) and
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
