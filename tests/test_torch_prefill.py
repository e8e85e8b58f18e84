"""The port's recurrentgemma-9b slice as a whole against the JAX package
on the CPU: the prefill step, decode with RG-LRU states and local-attention
rings, and the serving loop, on the reduced config (38 layers of width 64,
window 32, f32) with JAX's own weights carried across
(`convert.lm_from_numpy`). Logits within test_torch_lm.py's 1e-5; the
port's decode against its own prefill within 1e-4 (another order of the
same f32 sums, over 38 layers), the twin of JAX's
test_decode_matches_forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from torch_parity import (jax_and_port_models, same,  # noqa: F401
                          torch_one_thread)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def rgemma():
    return jax_and_port_models(ARCH, seed=1)


@pytest.mark.parametrize("name", [ARCH, "deepseek-moe-16b", "smollm-135m"])
def test_prefill_step_matches_jax(name):
    """make_prefill_step over 40 tokens (past recurrentgemma's window of
    32): last-position logits; the hybrid, MoE and dense decoders."""
    jcfg, params, tcfg, model = jax_and_port_models(name, seed=3)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 40)).astype(
        np.int32)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(tok)})
    got = tsteps.make_prefill_step(tcfg)(model,
                                         {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_matches_jax(rgemma):
    """40 teacher-forced decode steps at max_len 40: the LATTN rings of 32
    slots wrap from step 33 on; logits, greedy tokens and positions agree
    every step, and the last step's RG-LRU states too."""
    jcfg, params, tcfg, model = rgemma
    B, L = 3, 40
    sj = jlm.init_decode_state(jcfg, B, L)
    st = tlm.init_decode_state(tcfg, B, L, device="cpu")
    step = jax.jit(lambda p, s, t: jlm.decode_step(p, jcfg, s, t))
    rng = np.random.default_rng(12)
    for _ in range(L):
        tok = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        lj, sj = step(params, sj, jnp.asarray(tok))
        lt, st = tlm.decode_step(model, st, torch.as_tensor(tok))
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj, **TOL)
        same(lt.argmax(-1), lj.argmax(-1))
    same(st["pos"], sj["pos"])
    np.testing.assert_allclose(st["caches"][0][0].numpy(),
                               np.asarray(sj["caches"][0][0][0]), **TOL)


def test_generate_matches_jax_serve():
    """The port's greedy loop against the JAX package's serving loop
    (repro.launch.serve.main) on reduced recurrentgemma-9b: the same
    weights and prompts give the same tokens."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "3", "--prompt-len",
            "4", "--gen-len", "3", "--seed", "2"]
    want = jserve.main(argv)
    _, _, tcfg, model = jax_and_port_models(ARCH, seed=2)
    prompts = np.random.default_rng(2).integers(0, tcfg.vocab, (3, 4))
    got, _, state = tserve.generate(model, prompts, 3)
    same(got, want)
    assert set(state["backends"]) == {"decode"}


def test_decode_matches_prefill(rgemma):
    """The port alone: logits of 48 teacher-forced decode steps (rings
    wrap) equal the train-mode forward's logits at every position within
    1e-4, and the prefill step's (logits of the last position alone) at
    the last within 1e-5."""
    _, _, tcfg, model = rgemma
    B, L = 2, 48
    tok = torch.as_tensor(np.random.default_rng(13).integers(
        0, tcfg.vocab, (B, L)).astype(np.int32))
    full = tlm.logits_fn(model, tcfg, tlm._forward(model, tcfg, tok))
    state = tlm.init_decode_state(tcfg, B, L, device="cpu")
    for t in range(L):
        logits, state = tlm.decode_step(model, state, tok[:, t])
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)
    last = tsteps.make_prefill_step(tcfg)(model, {"tokens": tok})
    torch.testing.assert_close(last, full[:, -1], **TOL)
