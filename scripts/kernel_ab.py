#!/usr/bin/env python3
"""Time one of this checkout's CUDA sources against another version of it
(for example the parent commit's), on one card, at the main path's own
calls:

    python3 scripts/kernel_ab.py owner_lane --other path/to/owner_lane.cu
    python3 scripts/kernel_ab.py hash_insert --other path/to/hash_probe.cu
    python3 scripts/kernel_ab.py rg_lru --other path/to/rg_lru.cu
    python3 scripts/kernel_ab.py moe_dispatch --other path/to/moe_dispatch.cu
    python3 scripts/kernel_ab.py moe_dispatch --other path/to/moe_dispatch.cu \
        --sweep 48,1024,4096
    python3 scripts/kernel_ab.py hash_find --other path/to/hash_probe.cu
    python3 scripts/kernel_ab.py syncs --other path/to/other/src [--pairs 10]
    python3 scripts/kernel_ab.py staging

The other source must export the same C interface (for example the file
from an earlier commit, unpacked with `git archive` into a directory that
.gitignore lists); it stands in for this checkout's library through
`_build.load_file` and `_launch.library`. Each mode drives chip_smoke.py's
own path at full size and keeps the inputs of the kernel's calls there. On
each kept call it checks that both versions give the same bits, then times
each as chip_smoke.py's phase 3 does (median of single calls after an L2
flush) in the order other, this, this, other. Then it drives the path whole
with each version, alternating, and reports every drive, their median and
how many of the paired drives each side won (the host's noise is wide):

- owner_lane (B1 amo_apply, B2 fused_apply): the hash table's RDMA unfused
  and fused arms to load 0.25 and the queue's RDMA arm; the calls are the
  first amo_apply / fused_apply of the last insert batch and the first
  queue push, each also with the mask cleared (what a call costs with no
  live op: the copy, the zeroed replies and the walk over the mask); ten
  drives of each side, median batch of each operation.
- hash_insert (B4; the source also holds B3, which the RPC finds run): the
  hash table's RPC arm to load 0.25; the call is the first insert of the
  last batch, also with the mask cleared; ten drives of each side.
- rg_lru (B8): recurrentgemma-9b at full width with seeded weights; the
  calls are the prefill's last rg_lru_scan (1 x 32,768 x 4,096) and a
  decode step's last one (8 x 1 x 4,096, h0 given); three prefills of each
  side, timed on the host clock.
- moe_dispatch (B7): deepseek-moe-16b at full width with seeded weights;
  the calls are its prefill's last moe_dispatch (196,608 ids over 64
  experts, 1 x 32,768 tokens) and a decode step's last one (8 tokens x
  top-6 = 48 ids); three prefills of each side, timed on the host clock.
  With --sweep T1,T2,... it times only calls of T seeded ids uniform over
  64 experts at each T given, and drives no model.
- hash_find (B3; the source also holds B4, which the RPC inserts run):
  the hash table's RPC arm to load 0.25; the call is the first find
  batch's, also with the mask cleared; ten drives of each side.

- syncs (no kernel: the Python front doors): `--other` is another tree of
  the package (an earlier commit's `src/`, unpacked with `git archive`).
  Each drive is a process of its own that imports one tree and, at
  chip_smoke.py phase 2's size, calls each synchronous front door on host
  (numpy) arrays: the hash table (64 ranks x 2**18 slots, val_words 1)
  takes an insert and a find of 64 x 1,024 keys on rpc, rdma_fused and
  rdma (unfused), the hosted queue (capacity 2**20, 2 words a slot) a
  push of 64 x 256 items and a pop of 256 a rank on rdma and rpc. Each
  call runs once to warm up, once under chip_smoke.py's SyncCounter
  (`torch.cuda.set_sync_debug_mode("warn")`: every synchronizing
  operation counts, by the file:line that triggered it), then 15 times on
  the state the warm-up left, each ending in a synchronize; a drive's ms
  is their median. The trees alternate, other and this, then this and
  other, for `--pairs` pairs (default 10). It prints each call's syncs on
  both sides, each side's median drive, the pairs this tree won and the
  range of this / other over the pairs.

- staging (no kernel, no `--other`): the host staging of the front
  doors' host arrays at phase 2's size (keys 64 x 1,024 int32, values 64 x
  1,024 x 1, queue items 64 x 256 x 2) through this checkout's
  `types.to_device` (pinned memory, a non-blocking copy) against a
  pageable `torch.as_tensor(..., device=)`, in alternating blocks of 200
  calls, 10 blocks a side: the median µs a call until the host has the
  tensor back, and until a synchronize after it.

It prints one line a measurement, the card's name and power limit, and a
JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBS = {"owner_lane": "owner_lane", "hash_insert": "hash_probe",
        "rg_lru": "rg_lru", "moe_dispatch": "moe_dispatch",
        "hash_find": "hash_probe"}
REPS = 20
ORDER = ("other", "this", "this", "other")
ROUNDS = 5                                  # ten drives of each side
PREFILL_ORDER = ("other", "this", "this", "other", "other", "this")


def time_calls(cs, use, card: str, calls: dict, flush) -> dict:
    """calls: label -> (tag, wrapper, args, kw, mask index or None). Both
    versions must agree; each is timed in ORDER, also with the mask
    cleared where there is one."""
    import torch
    out = {}
    for label, (tag, fn, args, kw, mask_at) in calls.items():
        got = {}
        for which in ("other", "this"):
            with use(which):
                got[which] = fn(*args, **kw)
        pairs = (zip(got["other"], got["this"]) if isinstance(got["this"],
                                                              tuple)
                 else [(got["other"], got["this"])])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{label}: the two versions differ")
        runs = [("ms", args)]
        row = dict(at=tag, shapes=[None if a is None else tuple(a.shape)
                                   for a in args])
        if mask_at is not None:
            mask = args[mask_at]
            row["live"] = int(mask.sum())
            cleared = list(args)
            cleared[mask_at] = torch.zeros_like(mask)
            runs.append(("ms_no_live", cleared))
        for what, a in runs:
            times = {"other": [], "this": []}
            for which in ORDER:
                with use(which):
                    times[which].append(cs.cuda_ms_cold(
                        lambda: fn(*a, **kw), REPS, flush))
            for which, ts in times.items():
                row[f"{which}_{what}"] = statistics.median(ts)
                row[f"{which}_{what}_runs"] = ts
        out[label] = row
        cleared_txt = ("" if mask_at is None else
                       f"; with the mask cleared other "
                       f"{row['other_ms_no_live']:.4f} ms, this "
                       f"{row['this_ms_no_live']:.4f} ms")
        print(f"{label} at {tag} {row['shapes']}: other "
              f"{row['other_ms']:.4f} ms, this {row['this_ms']:.4f} ms"
              f"{cleared_txt} ({card})", flush=True)
    return out


def paired(runs: dict, key: str, card: str, unit: str) -> dict:
    """Median of each side's drives and the pairs this side won (the i-th
    drive of each side; the drives alternate)."""
    row = {which: statistics.median(r[key] for r in rs)
           for which, rs in runs.items()}
    row["runs"] = {which: [r[key] for r in rs] for which, rs in runs.items()}
    row["this_wins"] = sum(t < o for t, o in zip(row["runs"]["this"],
                                                 row["runs"]["other"]))
    print(f"median {unit}, {key}: other {row['other']:.4f}, this "
          f"{row['this']:.4f}; this won {row['this_wins']} of "
          f"{len(row['runs']['this'])} pairs (runs {row['runs']}) ({card})",
          flush=True)
    return row


def table_drive(cs, device, seed: int, arms, queue: bool):
    """Drives of chip_smoke.py's phase-2 arms: returns drive(mark) -> median
    ms per batch of each arm's operations."""
    import torch
    sync = torch.cuda.synchronize
    x = cs.slice_inputs(seed, cs.TARGET_KEYS // (cs.P * cs.N), device)
    k, v, qk, items = x["keys"], x["vals"], x["queries"], x["items_dev"]

    def drive(mark=cs.no_mark) -> dict:
        med = {}
        for arm in arms:
            r = cs.ht_arm(arm, k, v, qk, cs.NSLOTS, device, sync, mark)
            med[f"{arm} insert"] = statistics.median(r["t_insert"]) * 1e3
            med[f"{arm} find"] = statistics.median(r["t_find"]) * 1e3
        if queue:
            r = cs.q_arm("rdma", items, cs.Q_HOST, cs.Q_CAP, device, sync,
                         mark)
            med["queue rdma push"] = statistics.median(r["t_push"]) * 1e3
            med["queue rdma pop"] = statistics.median(r["t_pop"][:-1]) * 1e3
        return med
    return drive


def drives(drive, use, card: str) -> dict:
    runs = {"other": [], "this": []}
    for _ in range(ROUNDS):
        for which in ORDER:
            with use(which):
                runs[which].append(drive())
    return {key: paired(runs, key, card, "ms per batch")
            for key in runs["this"][0]}


def owner_lane_mode(cs, use, card, device, seed, flush) -> dict:
    from repro_torch.kernels import amo_apply as kamo
    drive = table_drive(cs, device, seed, ("rdma_unfused", "rdma_fused"),
                        queue=True)
    with cs.Capture() as capture:
        drive(capture.mark)
    calls = {}
    for label, name, tag in (
            ("amo_apply", "amo_apply", "ht rdma_unfused insert last"),
            ("fused_apply", "fused_apply", "ht rdma_fused insert last"),
            ("queue push amo_apply", "amo_apply", "queue rdma push")):
        args, kw = capture.calls[(name, tag)]
        calls[label] = (tag, getattr(kamo, name), args, kw, 2)
    out = time_calls(cs, use, card, calls, flush)
    for label, (_, fn, args, _, _) in calls.items():
        out[label]["word_chain"] = cs.word_chain(fn.__name__, args)
    return {"calls": out, "batches": drives(drive, use, card)}


def rpc_mode(cs, use, card, device, seed, flush, name: str, tag: str,
             mask_at: int) -> dict:
    """A handler kernel of csrc/hash_probe.cu at its call `tag` of the RPC
    arm, also with the mask cleared; ten drives of each side."""
    from repro_torch.kernels import hash_probe as khp
    drive = table_drive(cs, device, seed, ("rpc",), queue=False)
    with cs.Capture() as capture:
        drive(capture.mark)
    args, kw = capture.calls[(name, tag)]
    out = time_calls(cs, use, card, {
        name: (tag, getattr(khp, name), args, kw, mask_at)}, flush)
    out[name]["component_chain"] = cs.component_chain(name, args, kw)
    out[name]["serial_chain"] = cs.serial_chain(name, args)
    return {"calls": out, "batches": drives(drive, use, card)}


def model_mode(cs, use, card, device, seed, flush, arch: str, name: str,
               prefill_tag: str) -> dict:
    """Kernel `name` at the last call of a prefill of `arch` at full width
    (phase 8's cut) and of a decode step of phase 5's batch; then three
    prefills of each side."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = registry.get(arch)
    model = lm.init_lm(cfg, seed, device)
    B, S = cs.PREFILL["batch"], cs.PREFILL["seq_len"]
    tokens = torch.as_tensor(np.random.default_rng(seed + 8).integers(
        0, cfg.vocab, (B, S)).astype(np.int32), device=device)
    step = steps.make_prefill_step(cfg)
    kernel = cs.wrappers()[name]
    with cs.Capture(last=True) as capture:
        capture.mark(prefill_tag)
        step(model, {"tokens": tokens})
        Bd = cs.SERVE["batch"]
        state = lm.init_decode_state(cfg, Bd, 16, device=device)
        capture.mark("decode step")
        lm.decode_step(model, state, torch.zeros(Bd, dtype=torch.int32,
                                                 device=device))
    del state
    calls = {}
    for tag in (prefill_tag, "decode step"):
        args, kw = capture.calls[(name, tag)]
        calls[f"{name} {tag}"] = (tag, kernel, args, kw, None)
    del capture
    out = time_calls(cs, use, card, calls, flush)
    runs = {"other": [], "this": []}
    for which in PREFILL_ORDER:
        with use(which):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(model, {"tokens": tokens})
            torch.cuda.synchronize()
            runs[which].append({"prefill": time.perf_counter() - t0})
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill ({which}): logits not finite")
    return {"calls": out, "batches": {
        "prefill": paired(runs, "prefill", card,
                          f"s per prefill of {B} x {S} tokens")}}


MODES = {"owner_lane": owner_lane_mode,
         "hash_insert": functools.partial(rpc_mode, name="hash_insert",
                                          tag="ht rpc insert last",
                                          mask_at=4),
         "hash_find": functools.partial(rpc_mode, name="hash_find",
                                        tag="ht rpc find", mask_at=3),
         "rg_lru": functools.partial(
             model_mode, arch="recurrentgemma-9b", name="rg_lru_scan",
             prefill_tag="prefill"),
         "moe_dispatch": functools.partial(
             model_mode, arch="deepseek-moe-16b", name="moe_dispatch",
             prefill_tag="ds prefill")}


def sweep_mode(cs, use, card, device, seed, flush, counts) -> dict:
    """moe_dispatch on T seeded ids uniform over 64 experts, each T of
    `counts`."""
    import numpy as np
    import torch
    kernel = cs.wrappers()["moe_dispatch"]
    rng = np.random.default_rng(seed + 9)
    calls = {}
    for T in counts:
        ids = torch.as_tensor(rng.integers(0, 64, T).astype(np.int32),
                              device=device)
        calls[f"moe_dispatch T = {T}"] = ("sweep", kernel, (ids,),
                                          {"n_experts": 64}, None)
    return {"calls": time_calls(cs, use, card, calls, flush)}


SYNC_P, SYNC_NSLOTS, SYNC_N, SYNC_QN, SYNC_QCAP = 64, 2 ** 18, 1024, 256, \
    2 ** 20
SYNC_REPS = 15


def count_syncs(src: str) -> dict:
    """One drive of the syncs mode in this process, with the package tree
    `src`: {call: {"syncs", "sites", "ms"}} and the tree imported."""
    import numpy as np
    import torch
    sys.path[:0] = [str(ROOT), src]
    from chip_smoke import SyncCounter
    import repro_torch
    from repro_torch.core import am, hashtable as ht, queue as dq
    from repro_torch.core.types import Promise
    P, N, QN = SYNC_P, SYNC_N, SYNC_QN
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    keys = rng.choice(2 ** 30, size=(P, N), replace=False).astype(np.int32)
    vals = (keys * 7)[..., None]
    items = rng.integers(0, 2 ** 20, (P, QN, 2)).astype(np.int32)
    table = ht.make_hashtable(P, SYNC_NSLOTS, 1, device=dev)
    engine = am.AMEngine(P)
    ht.build_am_handlers(table, engine)
    queue = dq.make_queue(P, 0, SYNC_QCAP, 2, device=dev)
    qengine = am.AMEngine(P)
    dq.build_am_handlers(queue, qengine)
    calls = {
        "rpc insert": lambda: ht.insert_rpc(table, engine, keys, vals),
        "rpc find": lambda: ht.find_rpc(table, engine, keys),
        "rdma_fused insert": lambda: ht.insert_rdma(table, keys, vals),
        "rdma_fused find": lambda: ht.find_rdma(table, keys),
        "rdma insert": lambda: ht.insert_rdma(table, keys, vals,
                                              fused=False),
        "rdma find": lambda: ht.find_rdma(table, keys, fused=False),
        "queue rdma push": lambda: dq.push_rdma(queue, items,
                                                promise=Promise.CRW),
        "queue rdma pop": lambda: dq.pop_rdma(queue, QN,
                                              promise=Promise.CR),
        "queue rpc push": lambda: dq.push_rpc(queue, qengine, items),
        "queue rpc pop": lambda: dq.pop_rpc(queue, qengine, QN),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        syncs = SyncCounter()
        syncs(fn)
        torch.cuda.synchronize()
        times = []
        for _ in range(SYNC_REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(syncs=syncs.total, sites=syncs.sites,
                         ms=statistics.median(times))
    return {"tree": str(Path(repro_torch.__file__).parents[1]),
            "calls": out}


def syncs_mode(other: Path, pairs: int, card: str) -> dict:
    """Drives of count_syncs, a process each, the two trees alternating."""
    trees = {"other": str(other.resolve()), "this": str(ROOT / "src")}
    got = {"other": [], "this": []}
    for i in range(pairs):
        for which in (("other", "this") if i % 2 == 0 else
                      ("this", "other")):
            res = subprocess.run(
                [sys.executable, __file__, "syncs", "--other", str(other),
                 "--count-src", trees[which]],
                capture_output=True, text=True, check=True)
            got[which].append(json.loads(res.stdout.splitlines()[-1]))
    out = {}
    for call in got["this"][0]["calls"]:
        runs = {w: [d["calls"][call] for d in ds]
                for w, ds in got.items()}
        syncs = {w: rs[0]["syncs"] for w, rs in runs.items()}
        print(f"{call}: syncs other {syncs['other']} "
              f"{runs['other'][0]['sites']}, this {syncs['this']} "
              f"{runs['this'][0]['sites']}", flush=True)
        row = paired(runs, "ms", card, f"ms per {call}")
        ratio = [t["ms"] / o["ms"] for t, o in zip(runs["this"],
                                                   runs["other"])]
        row.update(syncs=syncs, sites=runs["this"][0]["sites"],
                   ratio_min=min(ratio), ratio_max=max(ratio),
                   ratio_median=statistics.median(ratio))
        print(f"{call}: this / other over {len(ratio)} pairs: median "
              f"{row['ratio_median']:.4f}, range {row['ratio_min']:.4f}-"
              f"{row['ratio_max']:.4f} ({card})", flush=True)
        out[call] = row
    return {"trees": trees, "pairs": pairs, "calls": out}


def staging_mode(card: str, blocks: int = 10, reps: int = 200) -> dict:
    """types.to_device (this) against a pageable copy (other) of phase
    2's host arrays, alternating blocks of `reps` calls."""
    import numpy as np
    import torch
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.core.types import to_device
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    arrays = {"keys": rng.integers(0, 2 ** 30, (SYNC_P, SYNC_N)),
              "values": rng.integers(0, 2 ** 30, (SYNC_P, SYNC_N, 1)),
              "queue items": rng.integers(0, 2 ** 20, (SYNC_P, SYNC_QN, 2))}
    ways = {"this": lambda x: to_device(x, torch.int32, dev),
            "other": lambda x: torch.as_tensor(x, dtype=torch.int32,
                                               device=dev)}
    out = {}
    for name, x in arrays.items():
        x = x.astype(np.int32)
        for way in ways.values():      # warm both paths
            way(x)
        torch.cuda.synchronize()
        issue = {"other": [], "this": []}
        done = {"other": [], "this": []}
        for b in range(blocks):
            for which in (("other", "this") if b % 2 == 0 else
                          ("this", "other")):
                for _ in range(reps):
                    t0 = time.perf_counter()
                    ways[which](x)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    issue[which].append((t1 - t0) * 1e6)
                    done[which].append((t2 - t0) * 1e6)
        row = {f"{w}_{what}_us": statistics.median(v[w])
               for what, v in (("issue", issue), ("done", done))
               for w in ("other", "this")}
        out[name] = row
        print(f"staging {name} {x.shape}: median µs to issue / to done: "
              f"pageable {row['other_issue_us']:.1f} / "
              f"{row['other_done_us']:.1f}, pinned {row['this_issue_us']:.1f}"
              f" / {row['this_done_us']:.1f} ({card})", flush=True)
    return {"arrays": out, "blocks": blocks, "reps": reps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=sorted(MODES) + ["staging", "syncs"])
    ap.add_argument("--other", type=Path,
                    help="the other version of the mode's source (syncs: "
                    "the other package tree's src directory; staging: "
                    "none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", default="",
                    help="moe_dispatch only: comma-separated id counts to "
                    "time instead of the model's calls")
    ap.add_argument("--pairs", type=int, default=10,
                    help="syncs only: alternating pairs of drives")
    ap.add_argument("--count-src", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sweep and args.mode != "moe_dispatch":
        ap.error("--sweep is a moe_dispatch option")
    if (args.other is None) != (args.mode == "staging"):
        ap.error("--other is required, except by the staging mode")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.count_src:          # one drive of the syncs mode
        print(json.dumps(count_syncs(args.count_src)))
        return 0
    if args.mode in ("syncs", "staging"):
        sys.path[:0] = [str(ROOT)]
        from chip_smoke import card_line
        card = card_line()
        print(card, flush=True)
        res = (syncs_mode(args.other, args.pairs, card)
               if args.mode == "syncs" else staging_mode(card))
        print(json.dumps({"card": card, "mode": args.mode, **res}))
        return 0
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch

    card = cs.card_line()
    print(card, flush=True)
    lib = LIBS[args.mode]
    other = _build.load_file(args.other)
    if lib == "moe_dispatch" and not hasattr(
            other, "repro_moe_dispatch_work_words"):
        # a source from before the tile table writes the E counts alone
        other.repro_moe_dispatch_work_words = lambda T, E: E

    def use(which: str):
        """Run the block with this checkout's kernels or the other's."""
        return (_launch.library(lib, other) if which == "other"
                else contextlib.nullcontext())

    device = torch.device("cuda", 0)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    if args.sweep:
        res = sweep_mode(cs, use, card, device, args.seed, flush,
                         [int(t) for t in args.sweep.split(",")])
    else:
        res = MODES[args.mode](cs, use, card, device, args.seed, flush)
    print(json.dumps({"card": card, "mode": args.mode,
                      "other": str(args.other), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
