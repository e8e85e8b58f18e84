"""Quickstart on the PyTorch port: the paper's two data structures under
both implementation styles, the cost model choosing between them, and the
adaptive AUTO backend choosing per batch at runtime; the calls of
examples/quickstart.py, made through `repro_torch`.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # the CPU

On the card the owner lanes and the handlers are the CUDA kernels; on the
CPU their plain versions. Either way it prints examples/quickstart.py's
`[rdma]`, `[rpc ]`, `[model]` and `[auto ] insert+find ok=` lines letter
for letter.
"""
import argparse

import torch

from repro_torch.core import am, costmodel as cm, hashtable as ht, queue as dq
from repro_torch.core.adaptive import AdaptiveEngine
from repro_torch.core.types import Backend, OpStats, Promise

P = 8  # virtual ranks


def main(argv=None) -> list:
    """Run the quickstart on `--device` (default cuda); returns the lines
    it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_quickstart: torch sees no CUDA device (use "
                         "--device cpu for the plain versions on the CPU)")
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    # --- distributed hash table -------------------------------------------
    table = ht.make_hashtable(P, nslots=128, val_words=1, device=device)
    keys = torch.arange(P * 4, dtype=torch.int32,
                        device=device).reshape(P, 4) + 1
    vals = (keys * 10)[..., None]

    # RDMA style: CAS (claim) + PUT (write) + FAO (publish): 3 network phases
    table, ok, probes = ht.insert_rdma(table, keys, vals,
                                       promise=Promise.CRW)
    say(f"[rdma] fully-atomic insert: ok={bool(ok.all())} "
        f"max_probes={int(probes.max())} (cost model: "
        f"{cm.predict(cm.DSOp.HT_INSERT, Promise.CRW, Backend.RDMA):.1f} us "
        f"on Cori Aries)")

    # RPC style: one active-message round trip, probing runs in the handler
    # (the reply carries the handler's real probe count)
    engine = am.AMEngine(P)
    table2 = ht.make_hashtable(P, nslots=128, val_words=1, device=device)
    ht.build_am_handlers(table2, engine)
    table2, ok2, probes2 = ht.insert_rpc(table2, engine, keys, vals)
    found, got = ht.find_rpc(table2, engine, keys)
    say(f"[rpc ] insert+find: ok={bool(ok2.all() and found.all())} "
        f"(cost model: "
        f"{cm.predict(cm.DSOp.HT_INSERT, Promise.CRW, Backend.RPC):.1f} us)")

    # --- hosted queue --------------------------------------------------------
    q = dq.make_queue(P, host=0, capacity=256, val_words=1, device=device)
    q, okq = dq.push_rdma(q, keys[..., None], promise=Promise.CW)
    q, gotq, outq = dq.pop_rdma(q, 4, promise=Promise.CR)
    say(f"[rdma] phasal queue push/pop: pushed={int(okq.sum())} "
        f"popped={int(gotq.sum())}")

    # --- backend="auto": the adaptive layer picks the arm per batch ---------
    # The chooser's prior is the port's H100_SXM fit, not the JAX package's
    # Cori numbers, so the per-decision lines may name other arms and scores
    # than examples/quickstart.py prints; the ok line is the same.
    engine3 = am.AMEngine(P)
    chooser = AdaptiveEngine(P, am_engine=engine3, measure=True)
    table3 = ht.make_hashtable(P, nslots=128, val_words=1, device=device)
    table3, ok3, _ = ht.insert(table3, keys, vals, adaptive=chooser)
    table3, found3, _ = ht.find(table3, keys, adaptive=chooser)
    for d in chooser.log:
        scores = ", ".join(f"{a}: {s:.1f}" for a, s in d.scores.items())
        say(f"[auto ] {d.op.value}: arm={d.arm} skew={d.skew:.2f} "
            f"scores={{{scores}}}")
    say(f"[auto ] insert+find ok={bool(ok3.all() and found3.all())}")

    # --- the paper's punchline: the model picks the winner per workload -----
    for busy in (0.0, 1.0, 4.0, 16.0):
        b = cm.choose_backend(cm.DSOp.HT_INSERT, Promise.CRW,
                              OpStats(target_busy_us=busy))
        say(f"[model] insert with target busy {busy:4.1f}us -> {b.value}")

    # MoE dispatch as a data-structure op (DESIGN.md §3): ship tokens (RPC)
    # vs pull expert weights (RDMA)
    for tokens in (64, 4096, 262144):
        b = cm.choose_moe_backend(
            tokens_per_rank=tokens, d_model=2048,
            expert_bytes_per_rank=3 * 64 * 2048 * 1408 * 2)
        say(f"[model] MoE dispatch at {tokens:7d} tokens/rank -> {b.value}")
    return lines


if __name__ == "__main__":
    main()
