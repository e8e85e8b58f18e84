"""End-to-end training driver on the PyTorch port, the twin of
examples/train_lm.py: trains an LM with the full loop of
`repro_torch.launch.train` (deterministic pipeline, write-behind
checkpoints, straggler monitor, restart from the latest step) and asserts
that the loss falls.

The default trains a reduced smollm-135m; `--full` the real smollm-135m
config at batch 2 x 256 tokens.

  PYTHONPATH=src python examples/torch_train_lm.py               # the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 40
  PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300

Checkpoints go to `--ckpt` (default build/torch_train_lm beside the
examples); a second run with the same directory resumes from its latest
step.
"""
import argparse
from pathlib import Path

from repro_torch.launch import train

CKPT = Path(__file__).resolve().parent.parent / "build" / "torch_train_lm"


def main(argv=None) -> list:
    """Train on `--device` (default cuda); returns the losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    argv = ["--arch", "smollm-135m", "--steps", str(args.steps),
            "--ckpt", args.ckpt, "--ckpt-every", "50",
            "--lr", "3e-3", "--log-every", "10", "--device", args.device]
    if args.full:
        argv += ["--batch", "2", "--seq", "256"]
    else:
        argv += ["--reduced", "--batch", "16", "--seq", "64"]
    losses = train.main(argv)
    assert losses[-1] < losses[0], "training must reduce loss"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
