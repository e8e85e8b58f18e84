#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: builds the kernels,
drives the port's two main paths at full size, and checks them.

    python3 chip_smoke.py [--seed S] [--insert-batches B]

Phases, in order; any mismatch raises and the script exits non-zero:

1. Edge cases, on the card: each kernel and its plain version in
   kernels/ref.py must agree on small inputs. amo_apply, fused_apply,
   hash_find and hash_insert bit for bit, with masked rows, offsets outside
   the shard, every opcode and a full table; moe_dispatch bit for bit at
   T = 1, at a T that is not a multiple of its block, with every token on
   one expert, with ids outside [0, E), and at (T, E) = (48, 64) and
   (6144, 64); flash_decode within the stated tolerance at length 1,
   length = W and a length that is not a multiple of its tile, with 1 and
   8 query heads per kv head, in float32 and bfloat16.
2. The data structures at full size: a distributed hash table of 64 ranks
   x 2**18 slots (val_words 1; a 201 MB window) filled to load 0.25 with
   4,194,304 keys in batches of 1024 keys per rank, then 16 find batches
   of the same size (half present, half absent), on three arms (RDMA fused,
   RDMA unfused, RPC), each on a fresh table; and a hosted queue (host 0,
   capacity 2**20, 2 words a slot) pushed with 256 values per rank for 16
   batches and popped until empty, on the RDMA and RPC arms. Results are
   held against a host oracle. Kernel launch counters are zeroed just
   before this phase and read just after. The drive keeps the inputs of
   the first kernel call of each kernel in each marked batch: the first
   and the last insert batch (a fresh table and one at load 0.25), the
   first find batch and the first queue push and pop, on every arm.
3. Kernel against plain version on those captured inputs: each kernel and
   its plain version must agree bit for bit. Times of both are taken with
   CUDA events, the kernel's on single calls after an L2 flush; the bound
   counts the bytes these inputs need.
4. CPU against GPU at a small size (8 ranks x 4096 slots): the same op
   streams through the port on both devices; every reply and the final
   windows must be equal.
5. Serving deepseek-moe-16b at full width (28 layers, d_model 2048, 16
   heads of 128, 64 routed experts top-6 and 2 shared, vocab 102,400,
   bfloat16, 16.67 B seeded random weights) through
   repro_torch.launch.serve: 8 requests of a 256-token prompt, 64 tokens
   generated, 320 decode steps. Counters are zeroed just before and read
   just after; flash_decode and moe_dispatch must each launch 28 times a
   step. The inputs of each kernel's first call at the first and the last
   step are kept and then held against the plain versions (moe_dispatch
   bit for bit, flash_decode within the tolerance), timed as in phase 3. The
   last PROFILE_STEPS steps are traced with torch.profiler for the device
   time per step by kernel and the device's idle share.
6. CPU against GPU for the model: reduced deepseek-moe-16b in float32,
   the same seeded weights built once and moved, 8 teacher-forced decode
   steps; logits within the stated tolerance, greedy tokens printed.

Before the last line it prints the card's name and power limit, the
median time per batch of each data-structure arm and per decode step, one
JSON line with the report, and one JSON line with every kernel's launches,
error, times and bound. The last line is {"ok": true, "device": {...}}.
It needs one card and exits non-zero where torch sees none.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the slice at full size
P, NSLOTS, VW, N = 64, 2 ** 18, 1, 1024
TARGET_KEYS = 4_194_304                 # load factor 0.25
FIND_BATCHES = 16
Q_HOST, Q_CAP, Q_VW, Q_N, Q_BATCHES = 0, 2 ** 20, 2, 256, 16
# phase 4
SMALL = dict(P=8, NSLOTS=4096, N=128, BATCHES=3, Q_CAP=4096, Q_N=64)
# phase 5: the serving path at full width, and phase 6 at the reduced size
SERVE = dict(arch="deepseek-moe-16b", batch=8, prompt_len=256, gen_len=64)
MODEL_STEPS = 8
PROFILE_STEPS = 4       # the last decode steps of phase 5, traced
# flash_decode against its plain version: f32 math over the same inputs in
# another order and with an online softmax
DECODE_TOL = dict(o_rtol=1e-4, o_atol=1e-5, m_atol=1e-5, l_rtol=1e-4)
# phase 6: f32 logits of the reduced model, CPU against GPU (TF32 off)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# written before each timed call: > the 50 MB L2, and about 0.3 ms of
# work, so the host has launched the timed call before the card reaches it
L2_FLUSH_BYTES = 2 ** 30

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet
ARMS = ("rdma_fused", "rdma_unfused", "rpc")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Data, made from the seed with numpy
# ---------------------------------------------------------------------------
def make_keys(seed: int, count: int) -> np.ndarray:
    """`count` distinct non-negative int32 keys: i -> (a*i + b) mod 2**31
    with odd a is a bijection, so distinct indices give distinct keys."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(1, 2 ** 30)) * 2 + 1
    b = int(rng.integers(0, 2 ** 31))
    i = np.arange(count, dtype=np.uint64)
    return ((i * np.uint64(a) + np.uint64(b)) & np.uint64(0x7FFFFFFF)
            ).astype(np.int32)


def val_of(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.uint64)
    return ((k * np.uint64(2654435761) + np.uint64(12345))
            & np.uint64(0x7FFFFFFF)).astype(np.int32)


def find_queries(seed: int, n_present: int, absent: np.ndarray,
                 batches: int, p: int, n: int):
    """Per batch: half the rows name inserted-key indices, half absent
    keys, shuffled. Returns (idx (B, p, n) with -1 for absent, absent-key
    pick (B, p, n))."""
    rng = np.random.default_rng(seed + 1)
    half = p * n // 2
    idx = np.full((batches, p * n), -1, np.int64)
    pick = np.zeros((batches, p * n), np.int32)
    for b in range(batches):
        rows = rng.permutation(p * n)
        idx[b, rows[:half]] = rng.integers(0, n_present, half)
        pick[b, rows[half:]] = absent[b * half:(b + 1) * half]
    return idx.reshape(batches, p, n), pick.reshape(batches, p, n)


# ---------------------------------------------------------------------------
# The main path: hash table and queue arms through the entry points
# ---------------------------------------------------------------------------
def no_mark(tag) -> None:
    pass


def ht_arm(arm: str, keys, vals, queries, nslots: int, device, sync,
           mark=no_mark):
    """Insert every batch, then run every find batch, on a fresh table.
    `mark(tag)` names the first and last insert batch and the first find
    batch (None for the others). Returns replies (on the device), the
    final window and batch times."""
    from repro_torch.core import am, hashtable as ht
    p = keys.shape[1]
    table = ht.make_hashtable(p, nslots, VW, device=device)
    engine = None
    if arm == "rpc":
        engine = am.AMEngine(p)
        ht.build_am_handlers(table, engine)
    ok, probes, found, got, t_ins, t_find = [], [], [], [], [], []
    last = keys.shape[0] - 1
    for b in range(keys.shape[0]):
        stage = "first" if b == 0 else "last" if b == last else None
        mark(stage and f"ht {arm} insert {stage}")
        sync()
        t0 = time.perf_counter()
        if arm == "rpc":
            table, o, pr = ht.insert_rpc(table, engine, keys[b], vals[b])
        else:
            table, o, pr = ht.insert_rdma(table, keys[b], vals[b],
                                          fused=arm == "rdma_fused")
        sync()
        t_ins.append(time.perf_counter() - t0)
        ok.append(o)
        probes.append(pr)
    for b in range(queries.shape[0]):
        mark(f"ht {arm} find" if b == 0 else None)
        sync()
        t0 = time.perf_counter()
        if arm == "rpc":
            f, v = ht.find_rpc(table, engine, queries[b])
        else:
            table, f, v = ht.find_rdma(table, queries[b],
                                       fused=arm == "rdma_fused")
        sync()
        t_find.append(time.perf_counter() - t0)
        found.append(f)
        got.append(v)
    mark(None)
    import torch
    return dict(ok=torch.stack(ok), probes=torch.stack(probes),
                found=torch.stack(found), vals=torch.stack(got),
                data=table.win.data, t_insert=t_ins, t_find=t_find)


def q_arm(arm: str, items, host: int, cap: int, device, sync,
          mark=no_mark):
    """Push every batch (C_RW), then pop (C_R) until a pop gets nothing.
    `mark(tag)` names the first push and the first pop batch."""
    from repro_torch.core import am, queue as dq
    from repro_torch.core.types import Promise
    p, n = items.shape[1], items.shape[2]
    q = dq.make_queue(p, host, cap, Q_VW, device=device)
    engine = None
    if arm == "rpc":
        engine = am.AMEngine(p)
        dq.build_am_handlers(q, engine)
    pushed, got, popped, t_push, t_pop = [], [], [], [], []
    for b in range(items.shape[0]):
        mark(f"queue {arm} push" if b == 0 else None)
        sync()
        t0 = time.perf_counter()
        if arm == "rpc":
            q, ok = dq.push_rpc(q, engine, items[b])
        else:
            q, ok = dq.push_rdma(q, items[b], promise=Promise.CRW)
        sync()
        t_push.append(time.perf_counter() - t0)
        pushed.append(ok)
    for b in range(items.shape[0] + 2):
        mark(f"queue {arm} pop" if b == 0 else None)
        sync()
        t0 = time.perf_counter()
        if arm == "rpc":
            q, g, v = dq.pop_rpc(q, engine, n)
        else:
            q, g, v = dq.pop_rdma(q, n, promise=Promise.CR)
        sync()
        t_pop.append(time.perf_counter() - t0)
        got.append(g)
        popped.append(v)
        if not bool(g.any()):
            break
    mark(None)
    import torch
    return dict(pushed=torch.stack(pushed), got=torch.stack(got),
                popped=torch.stack(popped), data=q.win.data,
                t_push=t_push, t_pop=t_pop)


def queue_items(seed: int, batches: int, p: int, n: int) -> np.ndarray:
    """Item id in word 0 (global push order), a mix of it in word 1."""
    ids = np.arange(batches * p * n, dtype=np.int64) + seed
    mix = ((ids.astype(np.uint64) * np.uint64(0x9E3779B1))
           & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return np.stack([ids.astype(np.int32), mix], -1).reshape(
        batches, p, n, 2)


# ---------------------------------------------------------------------------
# Checks against the host oracle
# ---------------------------------------------------------------------------
def check_ht(res: dict, arm: str, present, idx, pick) -> None:
    ok = res["ok"].cpu().numpy().reshape(-1)
    found = res["found"].cpu().numpy()
    vals = res["vals"].cpu().numpy()[..., 0]
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    want_found = np.where(idx >= 0, ok[np.maximum(idx, 0)], False)
    if not np.array_equal(found, want_found):
        bad = int((found != want_found).sum())
        raise AssertionError(f"{arm}: {bad} finds disagree with the oracle")
    want_vals = np.where(want_found, val_of(qkeys), 0)
    if not np.array_equal(vals, want_vals):
        raise AssertionError(f"{arm}: found values disagree with val_of")


def check_queue(res: dict, arm: str, items: np.ndarray) -> None:
    if not bool(res["pushed"].all()):
        raise AssertionError(f"queue {arm}: a push failed")
    got = res["got"].cpu().numpy()
    popped = res["popped"].cpu().numpy()
    seq = popped[got]                       # (batch, src, slot) order
    flat = items.reshape(-1, Q_VW)
    if seq.shape != flat.shape or not np.array_equal(seq, flat):
        raise AssertionError(f"queue {arm}: pops are not the pushed items "
                             f"in ticket order")
    if bool(got[-1].any()):
        raise AssertionError(f"queue {arm}: not drained")


# ---------------------------------------------------------------------------
# Kernel capture, comparison, timing
# ---------------------------------------------------------------------------
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "amo_apply": ("src/repro_torch/kernels/csrc/owner_lane.cu",
                  "src/repro/kernels/amo_apply.py:161"),
    "fused_apply": ("src/repro_torch/kernels/csrc/owner_lane.cu",
                    "src/repro/kernels/amo_apply.py:292"),
    "hash_find": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                  "src/repro/kernels/hash_probe.py:73"),
    "hash_insert": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                    "src/repro/kernels/hash_probe.py:163"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:81"),
    "moe_dispatch": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                     "src/repro/kernels/moe_dispatch.py:66"),
}
# the kernels each main path runs (phase 2 and phase 5)
DS_KERNELS = ("amo_apply", "fused_apply", "hash_find", "hash_insert")
MODEL_KERNELS = ("flash_decode", "moe_dispatch")


def wrappers():
    from repro_torch.kernels import (amo_apply as kamo, flash_decode as kfd,
                                     hash_probe as khp, moe_dispatch as kmd)
    return {"amo_apply": kamo.amo_apply, "fused_apply": kamo.fused_apply,
            "hash_find": khp.hash_find, "hash_insert": khp.hash_insert,
            "flash_decode": kfd.flash_decode,
            "moe_dispatch": kmd.moe_dispatch}


def plain_versions():
    from repro_torch.kernels import ref as kref
    return {name: getattr(kref, name) for name in DS_KERNELS} | {
        "flash_decode": kref.decode_attention,
        "moe_dispatch": kref.moe_dispatch}


def launch_counter():
    """A function returning the launches of each kernel since its last
    call (it reads the wrappers' counters; it resets nothing)."""
    last = {name: fn.launches for name, fn in wrappers().items()}

    def since():
        now = {name: fn.launches for name, fn in wrappers().items()}
        delta = {name: now[name] - last[name] for name in now}
        last.update(now)
        return delta
    return since


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts(names) -> dict:
    """The launches since zero_counts(); raises if a kernel of the path
    never launched."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"{name} never launched on its main path")
    return counts


class Capture:
    """While entered, it sits over the kernels in kernels/ops.py and keeps
    the inputs of the first call of each kernel under each tag that
    `mark` names (tag None: keeps nothing). It launches nothing of its own:
    every call goes on to the wrapper, which counts it. flash_decode's
    inputs keep their strides (the cache is read through a view)."""

    def __init__(self):
        self.tag = None
        self.calls = {}            # (kernel, tag) -> (args, kwargs)

    def mark(self, tag) -> None:
        self.tag = tag

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops as kops
        self._saved = {name: getattr(kops, name) for name in KERNELS}

        def hook(name, fn):
            fmt = (torch.preserve_format if name == "flash_decode"
                   else torch.contiguous_format)

            def call(*args, **kw):
                key = (name, self.tag)
                if self.tag is not None and key not in self.calls:
                    self.calls[key] = ([a.clone(memory_format=fmt)
                                        for a in args], dict(kw))
                return fn(*args, **kw)
            return call

        for name, fn in self._saved.items():
            setattr(kops, name, hook(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops as kops
        for name, fn in self._saved.items():
            setattr(kops, name, fn)
        self.tag = None


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Median ms of one call with the L2 cache flushed before it (writing
    `flush`, larger than L2, which also keeps the card busy while the
    host launches the call)."""
    import torch
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in evs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def max_abs_err(a, b) -> int:
    import torch
    outs = []
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype mismatch {x.shape} {y.shape}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        outs.append(int(d.max()) if d.numel() else 0)
    return max(outs)


def decode_err(got, want, what: str) -> float:
    """flash_decode against its plain version: m, l and o / l within
    DECODE_TOL (raises otherwise). Returns max |o/l - o'/l'|."""
    import torch
    (o, m, l), (o_r, m_r, l_r) = got, want
    t = DECODE_TOL
    try:
        torch.testing.assert_close(m, m_r, rtol=0, atol=t["m_atol"])
        torch.testing.assert_close(l, l_r, rtol=t["l_rtol"], atol=0)
        out = o / l.clamp(min=1e-30)[..., None]
        out_r = o_r / l_r.clamp(min=1e-30)[..., None]
        torch.testing.assert_close(out, out_r, rtol=t["o_rtol"],
                                   atol=t["o_atol"])
    except AssertionError as e:
        raise AssertionError(f"flash_decode at {what}: kernel != plain "
                             f"version: {e}") from None
    return float((out - out_r).abs().max()) if out.numel() else 0.0


def kernel_err(name: str, got, want, what: str):
    """Bit for bit for the integer kernels; DECODE_TOL for flash_decode."""
    if name == "flash_decode":
        return decode_err(got, want, what)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} at {what}: kernel != plain version "
                             f"(max abs err {err})")
    return err


def find_probes(table, starts, keys, mask, nslots, rec_w, max_probes=8):
    """Records each live lookup reads before it decides (data-dependent
    bytes of the find bound)."""
    import torch
    P_, L = table.shape
    stop = ~mask
    taken = torch.zeros(starts.shape, dtype=torch.int64,
                        device=table.device)
    for j in range(max_probes):
        s = (starts.to(torch.int64) + j) % nslots
        base = s * rec_w
        state = torch.gather(table, 1, base) & 255
        k = torch.gather(table, 1, base + 1)
        taken += (~stop).to(torch.int64)
        stop = stop | ((state == 2) & (k == keys)) | (state == 0)
    return int(taken.sum())


def bound_bytes(name: str, args, kw, out) -> float:
    """Bytes the function must move on these inputs, each once: every
    output in full. flash_decode reads q, the lengths, and K and V of each
    row's valid prefix only; moe_dispatch reads the ids. Of the owner-lane
    and handler kernels' inputs: the mask in full; of the request inputs
    (descriptors, starts, keys, vals) only the live rows, since a masked
    row is decided by its mask byte; the shard in full where the function
    returns a new one (amo_apply, fused_apply, hash_insert), and for the
    find only the records its live probes read."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    if name == "flash_decode":
        q, k, v, length = args
        B, Hkv, S, d = k.shape
        valid = int(length.to("cpu").clamp(0, S).sum())
        kv = 2 * valid * Hkv * d * k.element_size()
        return kv + nbytes([q, length, *out])
    if name == "moe_dispatch":
        return nbytes([args[0], *out])
    mask = args[-1]
    n_live = int(mask.sum())

    def live(t):
        return n_live * (t.numel() // mask.numel()) * t.element_size()
    if name == "hash_find":
        table, starts, keys, mask = args
        probed = find_probes(table, starts, keys, mask, kw["nslots"],
                             kw["rec_w"]) * kw["rec_w"] * 4
        return probed + live(starts) + live(keys) + nbytes([mask, *out])
    shard, requests = args[0], args[1:-1]
    return (nbytes([shard, mask, *out])
            + sum(live(t) for t in requests))


def serial_chain(name: str, args):
    """Live ops at the busiest owner: the length of the serial walk of the
    owner-serialized kernels (None for the others)."""
    if name not in ("amo_apply", "fused_apply", "hash_insert"):
        return None
    return int(args[-1].sum(1).max())


def library_call(name: str, args):
    """One PyTorch call computing the same function on the same inputs,
    timed as a yardstick and used nowhere in the port (None where there is
    none). flash_decode: scaled_dot_product_attention of the one query
    over the masked cache, normalized output instead of the partials."""
    if name != "flash_decode":
        return None
    import torch
    import torch.nn.functional as F
    q, k, v, length = args
    S = k.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :]
            < length.to(torch.int64)[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True)


def edge_cases(device) -> None:
    """Small inputs with masked rows, offsets outside [0, L) both ways,
    every opcode, CAS chains, aux0 out of range, a full table; expert ids
    at T = 1, T not a multiple of the block, all on one expert, outside
    [0, E), and the serving shapes; decode lengths 1, W and one that is
    not a multiple of the tile, g = 1 and 8, float32 and bfloat16."""
    import torch
    from repro_torch.kernels import ops as kops, ref as kref
    rng = np.random.default_rng(3)

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    Pe, L, m = 3, 64, 96
    local = t(rng.integers(-4, 4, (Pe, L)))
    off = rng.integers(0, 6, (Pe, m))
    off = np.where(rng.random((Pe, m)) < 0.2,
                   rng.choice([-L - 3, -1, L, L + 9], (Pe, m)), off)
    mask = t(rng.random((Pe, m)) > 0.25, torch.bool)
    ops4 = t(np.stack([off, rng.integers(0, 12, (Pe, m)),
                       rng.integers(-4, 4, (Pe, m)),
                       rng.integers(-4, 4, (Pe, m))], -1))
    cases = [("amo_apply", kops.amo_apply, kref.amo_apply,
              (local, ops4, mask), {})]
    for V, G in ((2, 3), (0, 1)):
        ops = np.concatenate([np.stack([
            off, rng.integers(0, 12, (Pe, m)), rng.integers(-4, 4, (Pe, m)),
            rng.integers(0, 10, (Pe, m)), rng.integers(-3, L + 3, (Pe, m)),
            rng.integers(-5, 5, (Pe, m))], -1),
            rng.integers(0, 99, (Pe, m, V))], -1)
        cases.append(("fused_apply", kops.fused_apply, kref.fused_apply,
                      (local, t(ops), mask), {"reply_width": 1 + G}))
    nslots, rec_w = 16, 4
    for fill in (0.6, 1.0):
        tab = np.zeros((Pe, nslots, rec_w), np.int64)
        st = np.where(rng.random((Pe, nslots)) < fill,
                      rng.choice([1, 2, 2, 2], (Pe, nslots)), 0)
        tab[..., 0] = st + 256 * rng.integers(0, 2, (Pe, nslots)) * (st > 0)
        tab[..., 1] = rng.integers(0, 8, (Pe, nslots))
        tab[..., 2:] = rng.integers(0, 99, (Pe, nslots, 2))
        tab = t(tab.reshape(Pe, -1))
        starts = t(rng.integers(nslots - 4, nslots, (Pe, 40)))
        keys = t(rng.integers(0, 8, (Pe, 40)))
        vals = t(rng.integers(0, 99, (Pe, 40, 2)))
        mk = t(rng.random((Pe, 40)) > 0.2, torch.bool)
        kw = dict(nslots=nslots, rec_w=rec_w, max_probes=8)
        cases.append(("hash_find", kops.hash_find, kref.hash_find,
                      (tab, starts, keys, mk), kw))
        cases.append(("hash_insert", kops.hash_insert, kref.hash_insert,
                      (tab, starts, keys, vals, mk), kw))
    for T, E, kind in ((1, 64, "one token"), (1000, 7, "ragged"),
                       (700, 64, "one expert"), (500, 16, "outside"),
                       (48, 64, "serve"), (6144, 64, "wide")):
        ids = rng.integers(0, E, T)
        if kind == "one expert":
            ids[:] = 5
        if kind == "outside":
            ids = rng.integers(-2 * E - 2, 2 * E + 2, T)
        cases.append(("moe_dispatch", kops.moe_dispatch, kref.moe_dispatch,
                      (t(ids),), {"n_experts": E}))
    B, W, Hkv, d = 3, 321, 2, 128
    for g in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            q = t(rng.normal(size=(B, Hkv * g, d)), torch.float32)
            ck, cv = (t(rng.normal(size=(B, W, Hkv, d)), torch.float32)
                      for _ in range(2))
            args = (q.to(dtype), ck.to(dtype).transpose(1, 2),
                    cv.to(dtype).transpose(1, 2), t([1, W, 200]))
            cases.append(("flash_decode", kops.flash_decode,
                          kref.decode_attention, args, {}))
    for name, kernel, plain, args, kw in cases:
        kernel_err(name, kernel(*args, **kw), plain(*args, **kw),
                   "edge cases")


# The call whose numbers stand in a kernel's row of the kernels line: its
# main arm at the highest load the run reaches, or the last decode step
# (every call is listed too).
HEADLINE = {"amo_apply": "ht rdma_unfused insert last",
            "fused_apply": "ht rdma_fused insert last",
            "hash_find": "ht rpc find",
            "hash_insert": "ht rpc insert last",
            "flash_decode": "serve last step",
            "moe_dispatch": "serve last step"}


def phase_captured(calls: dict, names, phase: int) -> dict:
    """Each captured main-path call: kernel against plain version, both
    timed, and the bound of these inputs. A kernel's ms is the median of
    single calls each after an L2 flush (the main paths find their shards,
    caches and weights cold); warm_ms is the mean of calls back to back.
    Returns the rows of each kernel, one per captured call."""
    import torch
    wrap, plain_fns = wrappers(), plain_versions()
    rows = {name: [] for name in names}
    flush = None
    for (name, tag), (args, kw) in calls.items():
        if name not in names:
            continue
        kernel, plain = wrap[name], plain_fns[name]
        if flush is None:
            flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                device=args[0].device)
        out_k = kernel(*args, **kw)
        torch.cuda.synchronize()
        if name in MODEL_KERNELS:
            out_p = plain(*args, **kw)
            plain_ms = cuda_ms_cold(lambda: plain(*args, **kw), 10, flush)
        else:                       # the serial walks take seconds: once
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out_p = plain(*args, **kw)
            t1.record()
            torch.cuda.synchronize()
            plain_ms = t0.elapsed_time(t1)
        err = kernel_err(name, out_k, out_p, tag)
        reps = 20 if serial_chain(name, args) is not None else 100
        ms = cuda_ms_cold(lambda: kernel(*args, **kw), reps, flush)
        warm_ms = cuda_ms(lambda: kernel(*args, **kw), reps)
        lib = library_call(name, args)
        library_ms = None
        if lib is not None:
            lib()
            library_ms = cuda_ms_cold(lib, reps, flush)
        bound_ms = bound_bytes(name, args, kw, out_k) / HBM_BYTES_PER_S * 1e3
        shapes = [tuple(a.shape) for a in args]
        live = (int(args[-1].sum()) if name in DS_KERNELS
                else int(args[3].sum()) if name == "flash_decode"
                else int(args[0].shape[0]))    # valid cache rows; tokens
        rows[name].append(dict(at=tag, ms=ms, warm_ms=warm_ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               library_ms=library_ms, max_abs_err=err,
                               live=live, shapes=shapes,
                               serial_chain=serial_chain(name, args)))
        lib_txt = ("" if library_ms is None
                   else f", library {library_ms:.4f} ms")
        log(f"phase {phase}: {name} == plain at {tag} on {shapes} "
            f"({live} live): kernel {ms:.4f} ms (back to back "
            f"{warm_ms:.4f}), plain {plain_ms:.1f} ms{lib_txt}, bound "
            f"{bound_ms:.4f} ms (bytes), max err {err}")
        del out_k, out_p
    for name in names:
        if not rows[name]:
            raise AssertionError(f"the main path never called {name}")
        if HEADLINE[name] not in [r["at"] for r in rows[name]]:
            log(f"phase {phase}: {name} was not called at {HEADLINE[name]}; "
                f"its row shows {rows[name][-1]['at']}")
    return rows


def kernel_row(name: str, calls: list, launches: int) -> dict:
    """One entry of the kernels line: the headline call's numbers, the
    largest error of any call, and every call."""
    source, replaces = KERNELS[name]
    head = next((r for r in calls if r["at"] == HEADLINE[name]), calls[-1])
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in calls),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"], at=head["at"],
        serial_chain=head["serial_chain"],
        calls=[{k: r[k] for k in ("at", "live", "ms", "warm_ms", "plain_ms",
                                  "library_ms", "bound_ms", "max_abs_err",
                                  "serial_chain")}
               for r in calls])


# ---------------------------------------------------------------------------
# Phases 2 and 4
# ---------------------------------------------------------------------------
def phase_slice(seed: int, insert_batches: int, device,
                mark=no_mark) -> dict:
    import torch
    sync = torch.cuda.synchronize
    n_keys = insert_batches * P * N
    allkeys = make_keys(seed, n_keys + FIND_BATCHES * P * N // 2)
    present, absent = allkeys[:n_keys], allkeys[n_keys:]
    keys = present.reshape(insert_batches, P, N)
    idx, pick = find_queries(seed, n_keys, absent, FIND_BATCHES, P, N)
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    k = torch.as_tensor(keys, device=device)
    v = torch.as_tensor(val_of(keys)[..., None], device=device)
    qk = torch.as_tensor(qkeys, device=device)
    report = {}
    res = {}
    counts = launch_counter()
    for arm in ARMS:
        r = ht_arm(arm, k, v, qk, NSLOTS, device, sync, mark)
        check_ht(r, arm, present, idx, pick)
        failed = int((~r["ok"]).sum())
        log(f"phase 2: hash table {arm}: {n_keys - failed} of {n_keys} "
            f"keys in, {failed} out of probe window; finds match oracle")
        report[arm] = dict(insert_failed=failed,
                           insert_ms=statistics.median(r["t_insert"]) * 1e3,
                           find_ms=statistics.median(r["t_find"]) * 1e3,
                           insert_batches=insert_batches,
                           find_batches=FIND_BATCHES, launches=counts())
        if arm == "rpc":
            r.pop("data")
        res[arm] = r
    a, b = res["rdma_fused"], res["rdma_unfused"]
    for key in ("ok", "probes", "found", "vals", "data"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"rdma fused != unfused on {key}")
    # RPC places keys serially per request, RDMA probe-phase by probe-phase
    # across the batch: the tables differ, and so may the few keys whose
    # probe window fills up; every other visible result must agree.
    both = (a["ok"] == res["rpc"]["ok"]).all()
    differ = int((a["ok"] != res["rpc"]["ok"]).sum())
    same_q = torch.equal(a["found"], res["rpc"]["found"]) and torch.equal(
        a["vals"], res["rpc"]["vals"])
    if bool(both) and not same_q:
        raise AssertionError("rdma and rpc finds differ on equal tables")
    ok_a = a["ok"].reshape(-1).cpu().numpy()
    ok_r = res["rpc"]["ok"].reshape(-1).cpu().numpy()
    agree = np.where(idx >= 0, ok_a[np.maximum(idx, 0)]
                     == ok_r[np.maximum(idx, 0)], True)
    fa, fr = a["found"].cpu().numpy(), res["rpc"]["found"].cpu().numpy()
    va, vr = a["vals"].cpu().numpy(), res["rpc"]["vals"].cpu().numpy()
    if not (np.array_equal(fa[agree], fr[agree])
            and np.array_equal(va[agree], vr[agree])):
        raise AssertionError("rdma and rpc finds differ on agreed keys")
    log(f"phase 2: rdma fused == unfused bit for bit (replies and window); "
        f"rpc agrees on every find of a key both arms hold "
        f"({differ} keys in one arm's probe window only)")
    report["rdma_vs_rpc_insert_differ"] = differ
    del res, a, b
    items = queue_items(seed, Q_BATCHES, P, Q_N)
    it = torch.as_tensor(items, device=device)
    for arm in ("rdma", "rpc"):
        r = q_arm(arm, it, Q_HOST, Q_CAP, device, sync, mark)
        check_queue(r, arm, items)
        log(f"phase 2: queue {arm}: {items.shape[0] * P * Q_N} pushed and "
            f"popped in ticket order")
        report[f"queue_{arm}"] = dict(
            push_ms=statistics.median(r["t_push"]) * 1e3,
            pop_ms=statistics.median(r["t_pop"][:-1]) * 1e3,
            push_batches=len(r["t_push"]), pop_batches=len(r["t_pop"]),
            launches=counts())
    return report


def run_small(device, sync, seed: int) -> list:
    """The phase-3 streams at the small size; returns every reply and
    final window as host arrays."""
    from repro_torch.core.types import Promise
    from repro_torch.core import hashtable as ht
    import torch
    s = SMALL
    n_keys = s["BATCHES"] * s["P"] * s["N"]
    allkeys = make_keys(seed + 3, n_keys + s["P"] * s["N"] // 2)
    present, absent = allkeys[:n_keys], allkeys[n_keys:]
    keys = present.reshape(s["BATCHES"], s["P"], s["N"])
    idx, pick = find_queries(seed + 3, n_keys, absent, 1, s["P"], s["N"])
    qkeys = np.where(idx >= 0, present[np.maximum(idx, 0)], pick)
    k = torch.as_tensor(keys, device=device)
    v = torch.as_tensor(val_of(keys)[..., None], device=device)
    qk = torch.as_tensor(qkeys, device=device)
    out = []
    for arm in ARMS:
        r = ht_arm(arm, k, v, qk, s["NSLOTS"], device, sync)
        out += [r[x] for x in ("ok", "probes", "found", "vals", "data")]
    for fused in (True, False):       # the C_RW find and the C_W insert
        table = ht.make_hashtable(s["P"], s["NSLOTS"], VW, device=device)
        table, ok, pr = ht.insert_rdma(table, k[0], v[0], promise=Promise.CW,
                                       fused=fused)
        table, f, vv = ht.find_rdma(table, qk[0], promise=Promise.CRW,
                                    fused=fused)
        out += [ok, pr, f, vv, table.win.data]
    items = torch.as_tensor(queue_items(seed, 3, s["P"], s["Q_N"]),
                            device=device)
    for arm in ("rdma", "rpc"):
        r = q_arm(arm, items, 1, s["Q_CAP"], device, sync)
        out += [r[x] for x in ("pushed", "got", "popped", "data")]
    return [x.cpu().numpy() for x in out]


def phase_cpu_vs_gpu(seed: int, device) -> int:
    import torch
    gpu = run_small(device, torch.cuda.synchronize, seed)
    cpu = run_small("cpu", lambda: None, seed)
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if g.shape != c.shape or not np.array_equal(g, c):
            raise AssertionError(f"phase 4: output {i} differs CPU vs GPU")
    return len(gpu)


# ---------------------------------------------------------------------------
# Phases 5 and 6: the serving path
# ---------------------------------------------------------------------------
def phase_serve(seed: int, device, mark=no_mark) -> dict:
    """deepseek-moe-16b at full width through repro_torch.launch.serve:
    SERVE["batch"] requests, prompts fed token by token, then greedy
    generation. `mark(tag)` names the first and the last decode step.
    The caller zeroes the launch counts before and reads them after."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = registry.get(SERVE["arch"])
    B, P_len, G = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    steps = P_len + G
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    # params_count() leaves out the final norm and the padded vocab rows
    want = (cfg.params_count() + cfg.d_model
            + (cfg.vocab_padded - cfg.vocab) * cfg.d_model)
    if n_params != want:
        raise AssertionError(f"serve: {n_params} parameters on the card, "
                             f"the config gives {want}")
    log(f"phase 5: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, {cfg.n_experts} "
        f"experts top-{cfg.top_k} + {cfg.n_shared_experts} shared, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {n_params} parameters, {w_bytes} bytes "
        f"on the card, built in {init_s:.2f} s")
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                    (B, P_len))

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])

    def on_step(t):
        mark("serve first step" if t == 1 else
             "serve last step" if t == steps else None)
        if t == steps - PROFILE_STEPS + 1:
            prof.__enter__()

    t0 = time.perf_counter()
    gen, times, state = serve.generate(model, prompts, G, on_step=on_step,
                                       sync=torch.cuda.synchronize)
    total_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    mark(None)
    max_mem = torch.cuda.max_memory_allocated(device)
    gen = gen.cpu()
    if tuple(gen.shape) != (B, G + 1) or len(times) != steps:
        raise AssertionError(f"serve: {tuple(gen.shape)} tokens in "
                             f"{len(times)} steps")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError("serve: a generated token is outside the vocab")
    # bound of one step: every weight read once, plus K and V of the valid
    # prefix of every layer at the last step (length = steps)
    kv_last = (cfg.n_layers * 2 * B * steps * cfg.n_kv_heads * cfg.hd
               * cfg.compute_dtype.itemsize)
    step_ms = statistics.median(times) * 1e3
    return dict(model=model, state=state, gen=gen, report=dict(
        arch=cfg.name, layers=cfg.n_layers, batch=B, prompt_len=P_len,
        gen_len=G, steps=steps, params=n_params, weight_bytes=w_bytes,
        init_s=init_s, max_memory_allocated=max_mem,
        step_ms_median=step_ms, step_ms_min=min(times) * 1e3,
        step_ms_max=max(times) * 1e3, total_s=total_s,
        tok_per_s=B * steps / sum(times),
        generated_tok_per_s=B * G / total_s,
        step_bound_ms_weights=w_bytes / HBM_BYTES_PER_S * 1e3,
        step_bound_ms=(w_bytes + kv_last) / HBM_BYTES_PER_S * 1e3,
        backends={k: v.value for k, v in sorted(state["backends"].items())},
        first_tokens=gen[:2, :8].tolist(),
        profile=profile_summary(prof, times[-PROFILE_STEPS:], step_ms)))


def profile_summary(prof, window_s, step_ms: float) -> dict:
    """Device time per step by kernel over the traced steps, and the
    device's idle share: against the traced steps' own wall time (the
    tracer slows the host), and against the untraced median step."""
    from torch.autograd import DeviceType
    n = len(window_s)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in rows) / 1e3 / n
    if not rows:
        log("phase 5: the profiler recorded no device time")
        return dict(steps=n, device_ms_per_step=None)
    wall_ms = sum(window_s) * 1e3 / n
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return dict(
        steps=n, traced_wall_ms_per_step=wall_ms,
        device_ms_per_step=busy_ms,
        idle_share_traced=1 - busy_ms / wall_ms,
        idle_share_vs_median=1 - busy_ms / step_ms,
        top=[dict(name=k[:100], ms_per_step=t / 1e3 / n,
                  calls_per_step=c / n) for k, t, c in top])


def check_last_logits(served: dict) -> None:
    """One more decode step past the run: logits of the full vocab for
    every request, all finite."""
    import torch
    from repro_torch.models import lm
    model, gen = served["model"], served["gen"]
    logits, _ = lm.decode_step(model, served["state"],
                               gen[:, -1].to(model.embed.device))
    want = (gen.shape[0], model.cfg.vocab_padded)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"serve: logits {tuple(logits.shape)} (want "
                             f"{want}) or not finite")


def phase_model_cpu_vs_gpu(seed: int, device) -> dict:
    """Reduced deepseek-moe-16b in float32, weights built once on the CPU
    and moved, MODEL_STEPS teacher-forced decode steps on both devices:
    logits within LOGITS_TOL. Returns the greedy tokens of both and the
    largest difference."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get(SERVE["arch"]).reduced()
    cpu = lm.init_lm(cfg, seed, "cpu")
    gpu = copy.deepcopy(cpu).to(device)
    B = 4
    states = [lm.init_decode_state(cfg, B, MODEL_STEPS, device=d)
              for d in ("cpu", device)]
    rng = np.random.default_rng(seed + 6)
    toks, worst, gap = {"cpu": [], "gpu": []}, 0.0, float("inf")
    for step in range(MODEL_STEPS):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, B).astype(np.int32))
        lc, states[0] = lm.decode_step(cpu, states[0], tok)
        lg, states[1] = lm.decode_step(gpu, states[1], tok.to(device))
        lg = lg.cpu()
        try:
            torch.testing.assert_close(lg, lc, **LOGITS_TOL)
        except AssertionError as e:
            raise AssertionError(f"phase 6: logits differ CPU vs GPU at "
                                 f"step {step}: {e}") from None
        worst = max(worst, float((lg - lc).abs().max()))
        top2 = lc.topk(2, -1).values
        gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
        toks["cpu"].append(lc.argmax(-1).tolist())
        toks["gpu"].append(lg.argmax(-1).tolist())
    return dict(max_abs_err=worst, smallest_top2_gap=gap, tokens=toks,
                same_tokens=toks["cpu"] == toks["gpu"])


# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--insert-batches", type=int,
                    default=TARGET_KEYS // (P * N),
                    help="insert batches per arm (64 fill the table to "
                         "load 0.25; fewer is a cut, printed as such)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    full = TARGET_KEYS // (P * N)
    if args.insert_batches != full:
        log(f"cut: {args.insert_batches} insert batches per arm instead of "
            f"{full} (load {args.insert_batches / full * 0.25:.4f})")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    edge_cases(device)
    log(f"phase 1: edge cases equal on all {len(KERNELS)} kernels")

    with Capture() as capture:
        zero_counts()
        t0 = time.perf_counter()
        report = phase_slice(args.seed, args.insert_batches, device,
                             capture.mark)
        slice_s = time.perf_counter() - t0
        launches = read_counts(DS_KERNELS)
    log(f"phase 2: launches {launches} in {slice_s:.1f} s")

    rows = phase_captured(capture.calls, DS_KERNELS, 3)
    del capture

    n_out = phase_cpu_vs_gpu(args.seed, device)
    log(f"phase 4: {n_out} outputs equal on CPU and GPU")

    with Capture() as capture:
        zero_counts()
        served = phase_serve(args.seed, device, capture.mark)
        serve_launches = read_counts(MODEL_KERNELS)
    sv = served["report"]
    want = sv["layers"] * sv["steps"]
    for name in MODEL_KERNELS:
        if serve_launches[name] != want:
            raise AssertionError(f"phase 5: {name} launched "
                                 f"{serve_launches[name]} times, want "
                                 f"{sv['layers']} a step = {want}")
        launches[name] = serve_launches[name]
    check_last_logits(served)
    del served
    log(f"phase 5: launches {serve_launches} ({sv['layers']} a step for "
        f"each model kernel over {sv['steps']} steps); backends "
        f"{sv['backends']}; logits finite")
    rows.update(phase_captured(capture.calls, MODEL_KERNELS, 5))
    del capture

    model_check = phase_model_cpu_vs_gpu(args.seed, device)
    log(f"phase 6: reduced {SERVE['arch']} logits equal CPU vs GPU within "
        f"{LOGITS_TOL} over {MODEL_STEPS} steps (max abs err "
        f"{model_check['max_abs_err']:.3e}, smallest top-2 gap "
        f"{model_check['smallest_top2_gap']:.3e}); greedy tokens CPU "
        f"{model_check['tokens']['cpu']} GPU {model_check['tokens']['gpu']}")

    for arm in ARMS:
        r = report[arm]
        log(f"median ms per batch, hash table {arm}: insert "
            f"{r['insert_ms']:.3f}, find {r['find_ms']:.3f} ({card})")
    for arm in ("rdma", "rpc"):
        r = report[f"queue_{arm}"]
        log(f"median ms per batch, queue {arm}: push {r['push_ms']:.3f}, "
            f"pop {r['pop_ms']:.3f} ({card})")
    log(f"serve {sv['arch']}: median {sv['step_ms_median']:.3f} ms per "
        f"decode step of {sv['batch']} tokens (bound "
        f"{sv['step_bound_ms']:.3f} ms, weights alone "
        f"{sv['step_bound_ms_weights']:.3f}), {sv['tok_per_s']:.1f} tok/s "
        f"over {sv['steps']} steps, {sv['generated_tok_per_s']:.1f} "
        f"generated tok/s; init {sv['init_s']:.2f} s; peak memory "
        f"{sv['max_memory_allocated'] / 1e9:.2f} GB ({card})")
    pr = sv["profile"]
    if pr.get("device_ms_per_step") is not None:
        log(f"serve profile over the last {pr['steps']} steps: device busy "
            f"{pr['device_ms_per_step']:.3f} ms per step, idle "
            f"{pr['idle_share_vs_median']:.3f} of the median step")
        for r in pr["top"]:
            log(f"  {r['ms_per_step']:8.3f} ms/step {r['calls_per_step']:7.1f}"
                f" calls/step  {r['name']}")
    report["serve"] = sv
    report["model_cpu_vs_gpu"] = model_check
    kernels = [kernel_row(name, rows[name], launches[name])
               for name in KERNELS]
    shapes = {f"{name} at {r['at']}": r["shapes"]
              for name, calls in rows.items() for r in calls}
    log(json.dumps({"report": report, "card": card, "build_s": build_s,
                    "slice_s": slice_s, "seed": args.seed,
                    "shapes": shapes}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
