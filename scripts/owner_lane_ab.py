#!/usr/bin/env python3
"""Time this checkout's owner-lane kernels (B1 amo_apply, B2 fused_apply,
csrc/owner_lane.cu) against another version of that source, on one card,
at the main path's own calls:

    python3 scripts/owner_lane_ab.py --other path/to/owner_lane.cu

The other source must export the same C interface (for example the file
from an earlier commit, unpacked with `git archive` into a directory that
.gitignore lists). The script drives chip_smoke.py's phase-2 path at full
size: the hash table's RDMA unfused and fused arms to load 0.25 and the
queue's RDMA arm, keeping the inputs of the first amo_apply / fused_apply
call of the last insert batch and of the first queue push. On each kept
call it checks that both versions give the same bits, then times each as
chip_smoke.py's phase 3 does (median of single calls after an L2 flush)
in the order other, this, this, other: once as called, and once with the
mask cleared (what a call costs with no live op: the copy, the zeroed
replies and the walk over the mask). Then it drives the same three arms
whole with each version, ROUNDS times in the order other, this, this,
other, for the median batch of each operation in each drive (host clock,
as chip_smoke.py's phase 2 takes it); the host's noise is wide, so it
reports every drive, their median, and how many of the paired drives
each side won. It prints one line a measurement, the card's name and
power limit, and a JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = {"amo_apply": "ht rdma_unfused insert last",
         "fused_apply": "ht rdma_fused insert last",
         "queue push amo_apply": "queue rdma push"}
REPS = 20
ROUNDS = 5
ARMS = (("rdma_unfused", ("insert", "find")),
        ("rdma_fused", ("insert", "find")), ("queue rdma", ("push", "pop")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the owner_lane.cu to compare with")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("owner_lane_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, _launch, amo_apply as kamo

    card = cs.card_line()
    print(card, flush=True)
    other = _build.load_file(args.other)

    def use(which: str):
        """Run the block with this checkout's kernels or the other's."""
        return (_launch.library("owner_lane", other) if which == "other"
                else contextlib.nullcontext())

    # the main path: the arms of chip_smoke.py's phase 2, at full size
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    x = cs.slice_inputs(args.seed, cs.TARGET_KEYS // (cs.P * cs.N), device)
    k, v, qk, items = x["keys"], x["vals"], x["queries"], x["items_dev"]

    def drive(mark=cs.no_mark) -> dict:
        """Median ms per batch of each arm's operations."""
        med = {}
        for arm, _ in ARMS[:2]:
            r = cs.ht_arm(arm, k, v, qk, cs.NSLOTS, device, sync, mark)
            med[arm] = {"insert": statistics.median(r["t_insert"]) * 1e3,
                        "find": statistics.median(r["t_find"]) * 1e3}
        r = cs.q_arm("rdma", items, cs.Q_HOST, cs.Q_CAP, device, sync, mark)
        med["queue rdma"] = {
            "push": statistics.median(r["t_push"]) * 1e3,
            "pop": statistics.median(r["t_pop"][:-1]) * 1e3}
        return med

    with cs.Capture() as capture:
        drive(capture.mark)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    wrap = {"amo_apply": kamo.amo_apply, "fused_apply": kamo.fused_apply}
    out = {}
    for label, tag in CALLS.items():
        name = label.split()[-1]
        (local, ops, mask), kw = capture.calls[(name, tag)]
        fn = wrap[name]
        got = {}
        for which in ("other", "this"):
            with use(which):
                got[which] = fn(local, ops, mask, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got["other"],
                                                     got["this"])):
            raise AssertionError(f"{label}: the two versions differ")
        none = torch.zeros_like(mask)
        row = dict(at=tag, live=int(mask.sum()),
                   word_chain=cs.word_chain(name, (local, ops, mask)))
        for what, m in (("ms", mask), ("ms_no_live", none)):
            times = {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                with use(which):
                    times[which].append(cs.cuda_ms_cold(
                        lambda: fn(local, ops, m, **kw), REPS, flush))
            for which, ts in times.items():
                row[f"{which}_{what}"] = statistics.median(ts)
                row[f"{which}_{what}_runs"] = ts
        out[label] = row
        print(f"{label} at {tag} ({row['live']} live, longest word chain "
              f"{row['word_chain']}): other {row['other_ms']:.4f} ms, "
              f"this {row['this_ms']:.4f} ms; with the mask cleared other "
              f"{row['other_ms_no_live']:.4f} ms, this "
              f"{row['this_ms_no_live']:.4f} ms ({card})", flush=True)
    runs = {"other": [], "this": []}
    for _ in range(ROUNDS):
        for which in ("other", "this", "this", "other"):
            with use(which):
                runs[which].append(drive())
    medians = {}
    for arm, ops in ARMS:
        for op in ops:
            row = {which: statistics.median(r[arm][op] for r in rs)
                   for which, rs in runs.items()}
            row["runs"] = {which: [r[arm][op] for r in rs]
                           for which, rs in runs.items()}
            # pair the i-th drive of each side (drives alternate)
            row["this_wins"] = sum(t < o for t, o in zip(
                row["runs"]["this"], row["runs"]["other"]))
            medians[f"{arm} {op}"] = row
            print(f"median ms per batch, {arm} {op}: other "
                  f"{row['other']:.3f}, this {row['this']:.3f}; this won "
                  f"{row['this_wins']} of {len(row['runs']['this'])} pairs "
                  f"(runs {row['runs']}) ({card})", flush=True)
    print(json.dumps({"card": card, "other": str(args.other),
                      "calls": out, "batches": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
