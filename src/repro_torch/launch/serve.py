"""Serving entry point: batched greedy decoding with the KV cache (port of
`repro.launch.serve`). Weights are seeded random at the config's widths.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --batch 4 --prompt-len 12 --gen-len 20 --device cpu

`--device` defaults to cuda; there the path runs the CUDA kernels
(flash_decode and moe_dispatch for attention and MoE models, rg_lru_scan
for recurrentgemma-9b, mlstm_step and slstm_scan for xlstm-1.3b), on the
CPU their plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..models import lm
from . import steps


def generate(model: lm.LM, prompts, gen_len: int, *, on_step=None,
             sync=None):
    """Greedy decoding as the JAX package's serving loop does it:
    prompt_len + gen_len decode steps over a cache of prompt_len + gen_len
    + 1 slots, the prompt fed token by token through the decode path
    (teacher forcing), then each step's argmax fed back. The tokens after
    the prompt, gen_len + 1 of them, come back.

    prompts (B, prompt_len) ints. `on_step(t)` is called before step t
    (1-based). With `sync`, each step is timed on the host clock around
    work that ends in `sync()`. Returns (tokens (B, gen_len + 1) int32 on
    the model's device, per-step seconds (empty without sync), the final
    decode state)."""
    cfg = model.cfg
    device = model.embed.device
    prompts = torch.as_tensor(np.asarray(prompts).astype(np.int32),
                              device=device)
    B, prompt_len = prompts.shape
    max_len = prompt_len + gen_len + 1
    state = lm.init_decode_state(cfg, B, max_len, device=device)
    serve_step = steps.make_serve_step(cfg)
    tok = prompts[:, 0]
    outs, times = [], []
    for t in range(1, max_len):
        if on_step is not None:
            on_step(t)
        t0 = time.perf_counter()
        nxt, state = serve_step(model, state, {"tokens": tok})
        if sync is not None:
            sync()
            times.append(time.perf_counter() - t0)
        if t < prompt_len:
            tok = prompts[:, t]                # teacher force
        else:
            tok = nxt
            outs.append(tok)
    return torch.stack(outs, dim=1), times, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: torch sees no CUDA device (use --device "
                         "cpu for the plain versions on the CPU)")
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    model = lm.init_lm(cfg, args.seed, device)
    sync()
    t0 = time.perf_counter()
    gen, _, state = generate(model, prompts, args.gen_len)
    sync()
    dt = time.perf_counter() - t0
    print(f"[serve] {args.batch} seqs x {args.gen_len} tokens in "
          f"{dt:.2f}s ({args.batch * args.gen_len / dt:.1f} tok/s) on "
          f"{device}")
    print("[serve] backends: " + ", ".join(
        f"{k} {v.value}" for k, v in sorted(state["backends"].items())))
    gen = gen.cpu().numpy()
    for b in range(min(args.batch, 2)):
        print(f"[serve] seq{b}: prompt={prompts[b].tolist()} "
              f"gen={gen[b].tolist()}")
    return gen


if __name__ == "__main__":
    main()
