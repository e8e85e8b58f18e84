"""End-to-end training driver (port of `repro.launch.train`): data
pipeline -> train_step -> async checkpointing -> straggler monitor ->
(simulated) elastic restart.

The loop is the JAX package's: deterministic batches keyed by (seed,
step, host), write-behind checkpoints, heartbeats after every step,
restart from the latest step on relaunch. On one device the mesh is
dropped (`--data` is accepted and unused, as `launch/serve.py` drops
it). Weights are seeded random (`lm.init_lm`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 20 --device cpu

`--device` defaults to cuda; there the path runs the CUDA kernels
(flash_attention with its backward, rg_lru_scan with its backward,
moe_dispatch), on the CPU their plain versions.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..configs.base import ShapeSpec
from ..data import SyntheticLM
from ..models import lm
from ..runtime import AsyncCheckpointer, StragglerMonitor
from ..runtime import checkpoint as ckpt_mod
from . import steps


def state_tree(model: lm.LM, opt_state) -> tuple:
    """The training state as a checkpoint tree: (the model's parameters in
    module order, the optimizer state)."""
    return (list(model.parameters()), opt_state)


@torch.no_grad()
def restore_state(directory: str, step: int, model: lm.LM, opt_state):
    """Load checkpoint `step` into the model's parameters and `opt_state`
    in place (each leaf copied onto its tensor's device)."""
    tree = state_tree(model, opt_state)
    leaves, _ = ckpt_mod.tree_flatten(tree)
    loaded, _ = ckpt_mod.tree_flatten(
        ckpt_mod.load_checkpoint(directory, step, tree))
    for dst, src in zip(leaves, loaded):
        dst.copy_(src)
    return model, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="schedule horizon (fixed across restarts)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="data,model",
                    help="mesh axes (unused on one device)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: torch sees no CUDA device (use --device "
                         "cpu for the plain versions on the CPU)")
    shape = ShapeSpec("cli", seq_len=args.seq, global_batch=args.batch,
                      kind="train", grad_accum=args.accum)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed)
    monitor = StragglerMonitor(n_hosts=1)
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None

    total = args.total_steps or args.steps
    init_fn, train_step = steps.make_train_step(
        cfg, lr=args.lr, warmup=min(20, total // 4 + 1), total_steps=total)
    model = lm.init_lm(cfg, args.seed, device)
    opt_state = init_fn(model)
    start = 0
    if args.ckpt:
        latest = ckpt_mod.latest_step(args.ckpt)
        if latest is not None:
            print(f"[train] restoring step {latest} from {args.ckpt}")
            restore_state(args.ckpt, latest, model, opt_state)
            start = latest

    losses = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = data.train_batch(cfg, shape, step, device=device)
        model, opt_state, metrics = train_step(model, opt_state, batch,
                                               step)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.heartbeat(0, step, time.time() - t0)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.submit(step + 1, state_tree(model, opt_state))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {time.time()-t0:.2f}s", flush=True)
        plan = monitor.plan()
        if plan:
            print(f"[train] straggler plan: {plan}")
    if ckpt:
        ckpt.submit(args.steps, state_tree(model, opt_state))
        ckpt.close()
    if losses:
        print(f"[train] done. loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
