"""The port's example twins (examples/torch_*.py) on the CPU.

examples/torch_quickstart.py must print examples/quickstart.py's
data-structure and cost-model lines letter for letter: the `[rdma]`,
`[rpc ]` and `[model]` lines and `[auto ] insert+find ok=`. The JAX
quickstart runs in a subprocess, as a user runs it. The per-decision
`[auto ]` lines may differ: the port's chooser prior is the H100 fit
(`costmodel.H100_SXM`), the JAX package's the Cori numbers. The serve twin
serves the three reduced models with `--device cpu` (its tokens differ
from examples/serve_lm.py's: the seeded weights are drawn by torch), and
the train twin trains a reduced smollm-135m for a few steps, the loss
falling, and resumes from its checkpoint.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SAME = ("[rdma]", "[rpc ]", "[model]", "[auto ] insert+find ok=")


def example(name: str):
    """Import examples/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args):
    """fn(*args) with its standard output kept: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def test_quickstart_twin_prints_jax_lines():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
        check=True).stdout.splitlines()
    lines, text = quiet(example("torch_quickstart").main, ["--device", "cpu"])
    assert text.splitlines() == lines
    want = [ln for ln in jax_out if ln.startswith(SAME)]
    got = [ln for ln in lines if ln.startswith(SAME)]
    assert len(want) == 11, jax_out
    assert got == want
    assert "[auto ] insert+find ok=True" in got
    # one decision line for the insert and one for the find, in both
    assert (sum(ln.startswith("[auto ] hash_") for ln in lines)
            == sum(ln.startswith("[auto ] hash_") for ln in jax_out) == 2)


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_lm",
                                  "torch_train_lm"])
def test_examples_run_on_the_card_by_default(name):
    """With no --device each twin runs on cuda, and raises where torch
    sees no card rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(SystemExit, match="no CUDA device"):
        quiet(example(name).main, [])


def test_serve_twin_on_cpu():
    gen, text = quiet(example("torch_serve_lm").main, ["--device", "cpu"])
    for arch in ("smollm-135m", "recurrentgemma-9b", "xlstm-1.3b"):
        assert f"--- {arch} (reduced) ---" in text
        tokens = np.asarray(gen[arch])
        assert tokens.shape[0] == 2 and tokens.shape[1] >= 10
        assert ((tokens >= 0) & (tokens < 256)).all()
    assert text.count("on cpu") == 3


def test_train_twin_on_cpu(tmp_path):
    """20 steps: the loss falls (the twin asserts it) and a checkpoint is
    written; a second run to 24 steps resumes from step 20."""
    ck = str(tmp_path / "ck")
    mod = example("torch_train_lm")
    losses, text = quiet(mod.main, ["--device", "cpu", "--steps", "20",
                                    "--ckpt", ck])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert "OK: loss" in text
    more, text = quiet(mod.main, ["--device", "cpu", "--steps", "24",
                                  "--ckpt", ck])
    assert "[train] restoring step 20" in text and len(more) == 4
