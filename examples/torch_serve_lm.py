"""Serving example on the PyTorch port: batched greedy decoding with
ring-buffer / recurrent caches across three architecture families, the
calls of examples/serve_lm.py made through `repro_torch`.

  PYTHONPATH=src python examples/torch_serve_lm.py               # the card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu  # the CPU

The weights are seeded random, drawn by torch, so the tokens differ from
examples/serve_lm.py's (drawn by jax.random) for the same seed.
"""
import argparse

from repro_torch.launch import serve

ARCHS = ("smollm-135m", "recurrentgemma-9b", "xlstm-1.3b")


def main(argv=None) -> dict:
    """Serve each reduced model on `--device` (default cuda); returns the
    generated tokens by arch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        print(f"\n--- {arch} (reduced) ---")
        out[arch] = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                                "--prompt-len", "6", "--gen-len", "10",
                                "--device", args.device])
    return out


if __name__ == "__main__":
    main()
