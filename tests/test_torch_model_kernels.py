"""Parity of the model kernels' plain versions with the JAX package.

repro_torch.kernels.ref is what the CPU runs and what the CUDA kernels are
held to on the card (tests/test_torch_cuda.py, chip_smoke.py). Here it is
held against the JAX oracles in repro.kernels.ref and against the Pallas
kernels in interpret mode, as tests/test_kernels.py runs them:

- moe_dispatch (B7): bit for bit;
- decode_attention and combine_decode_stats (B6): f32, over 1 and 4 kv
  shards, with test_kernels.py's tolerances (the same math summed in
  another order);
- the split-and-merge arithmetic of the B6 kernel: per-range partials
  merged in split order equal one pass, and JAX's combine of them;
- the port's one-device decode-attention body, which is what calls B6,
  against repro.models.lm.chunked_flash(..., kv_len=pos + 1), the function
  the JAX serving path runs there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro.kernels.moe_dispatch import moe_dispatch as pallas_moe_dispatch
from repro.models import lm as jlm
from repro_torch.core.types import Backend
from repro_torch.kernels import lane_cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from torch_parity import same, torch_one_thread  # noqa: F401


@pytest.mark.parametrize("T,E,bt", [(1, 64, 256), (48, 64, 256),
                                    (100, 4, 32), (1000, 7, 128),
                                    (6144, 64, 2048)])
def test_moe_dispatch_matches_jax_and_pallas(T, E, bt):
    """Ids in [0, E), the kernel's contract: the port's plain version
    equals the JAX oracle and the Pallas kernel (interpret mode, tile bt,
    with its padding correction) bit for bit, and ops dispatches a CPU
    tensor to it."""
    rng = np.random.default_rng(T + E)
    ids = rng.integers(0, E, T).astype(np.int32)
    if T > 1:
        ids[: T // 3] = E - 1          # a hot expert, and the padding alias
    c_t, p_t = tops.moe_dispatch(torch.as_tensor(ids), n_experts=E)
    c_j, p_j = jax.jit(jref.moe_dispatch, static_argnums=1)(
        jnp.asarray(ids), E)
    c_k, p_k = pallas_moe_dispatch(jnp.asarray(ids), n_experts=E,
                                   block_t=bt)
    for got, want in ((c_t, c_j), (p_t, p_j), (c_t, c_k), (p_t, p_k)):
        same(got, want)
    assert c_t.dtype == p_t.dtype == torch.int32


@pytest.mark.parametrize("T,one_expert", [(2047, False), (2048, False),
                                          (2049, False), (4097, True)])
def test_moe_dispatch_tile_edges_match_jax_and_pallas(T, one_expert):
    """T at either side of the CUDA kernel's tile of 2,048 ids, and two
    tiles + 1 with every id on one expert: the port's plain version equals
    the JAX oracle and the Pallas kernel (interpret mode, tile 2,048) bit
    for bit."""
    E = 64
    rng = np.random.default_rng(T)
    ids = (np.full(T, 17) if one_expert else rng.integers(0, E, T)
           ).astype(np.int32)
    c_t, p_t = tops.moe_dispatch(torch.as_tensor(ids), n_experts=E)
    c_j, p_j = jax.jit(jref.moe_dispatch, static_argnums=1)(
        jnp.asarray(ids), E)
    c_k, p_k = pallas_moe_dispatch(jnp.asarray(ids), n_experts=E,
                                   block_t=2048)
    for got, want in ((c_t, c_j), (p_t, p_j), (c_t, c_k), (p_t, p_k)):
        same(got, want)
    if one_expert:
        assert int(c_t[17]) == T and int(p_t[-1]) == T - 1


@pytest.mark.parametrize("edge", [2047, 2048, 4095, 4096])
def test_moe_dispatch_outside_range_at_tile_edge_matches_jax_ref(edge):
    """Ids outside [0, E) at the first and last index of a tile (2,048
    ids in the CUDA kernel), in [-E, 0) beside in-range ids of the column
    they wrap onto, and >= E: the plain version equals the JAX oracle."""
    E, T = 64, 3 * 2048 + 5
    rng = np.random.default_rng(edge)
    ids = rng.integers(0, 8, T).astype(np.int32)
    ids[edge] = -E + int(ids[edge - 1])
    ids[edge - 2] = E + 3
    ids[edge + 1] = -E - 1
    c_t, p_t = tops.moe_dispatch(torch.as_tensor(ids), n_experts=E)
    c_j, p_j = jax.jit(jref.moe_dispatch, static_argnums=1)(
        jnp.asarray(ids), E)
    same(c_t, c_j)
    same(p_t, p_j)
    assert int(p_t[edge]) == int((ids[:edge] == ids[edge] + E).sum())
    assert int(p_t[edge + 1]) == tref.INT32_MIN


MOE_CASES = [c for c in lane_cases.moe_dispatch_cases()
             if c[2][0].size * c[3]["n_experts"] <= 2 ** 24]


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=[
    label for label, _, _, _ in MOE_CASES])
def test_moe_dispatch_case_matches_jax_ref(i):
    """The B7 edge cases of kernels/lane_cases.py that the card tests and
    chip_smoke.py hold the CUDA kernel to (those whose one-hot stays under
    2**24 entries): the plain version against the JAX oracle."""
    _, _, (ids,), kw = MOE_CASES[i]
    c_t, p_t = tref.moe_dispatch(torch.as_tensor(ids), kw["n_experts"])
    c_j, p_j = jax.jit(jref.moe_dispatch, static_argnums=1)(
        jnp.asarray(ids), kw["n_experts"])
    same(c_t, c_j)
    same(p_t, p_j)


def test_moe_dispatch_outside_range_matches_jax_ref():
    """Ids outside [0, E): the plain version (and so the CUDA kernel)
    follows the JAX oracle: no count, an id in [-E, 0) reads the position
    column of id + E, any other id gets INT32_MIN. (The Pallas kernel
    instead folds ids >= E onto expert E-1.)"""
    E = 5
    ids = np.array([0, -1, 4, 5, -5, 4, -6, 1, 99, 4, -1, 0], np.int32)
    c_t, p_t = tref.moe_dispatch(torch.as_tensor(ids), E)
    c_j, p_j = jref.moe_dispatch(jnp.asarray(ids), E)
    same(c_t, c_j)
    same(p_t, p_j)
    assert int(p_t[3]) == tref.INT32_MIN
    assert int(p_t[1]) == 0 and int(p_t[10]) == 3   # -1 reads expert 4


def _qkv(rng, B, H, Hkv, S, d):
    return (rng.normal(size=(B, H, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,S,d,bk", [(2, 8, 2, 128, 32, 32),
                                            (3, 2, 1, 64, 16, 16),
                                            (2, 16, 16, 192, 128, 64)])
def test_decode_attention_matches_jax_and_pallas(B, H, Hkv, S, d, bk):
    """f32, lengths 1..S: the plain version against the JAX oracle and the
    Pallas flash_decode (interpret mode; S a multiple of its tile, as it
    needs) within test_kernels.py's tolerances (o 2e-5, m 1e-6, l 1e-5
    relative); at length 0 against the oracle (m = -inf, l = 0, o = 0)."""
    rng = np.random.default_rng(B * S + d)
    q, k, v = _qkv(rng, B, H, Hkv, S, d)
    length = rng.integers(1, S + 1, (B,)).astype(np.int32)
    length[0] = S
    got = tref.decode_attention(*map(torch.as_tensor, (q, k, v, length)))
    ref = jref.decode_attention(*map(jnp.asarray, (q, k, v, length)))
    pal = pallas_flash_decode(*map(jnp.asarray, (q, k, v, length)),
                              block_k=bk)
    for want in (ref, pal):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5)
    length[:] = 0
    got = tref.decode_attention(*map(torch.as_tensor, (q, k, v, length)))
    ref = jref.decode_attention(*map(jnp.asarray, (q, k, v, length)))
    for x, y in zip(got, ref):
        same(x, y)


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_partials_combine_like_jax(shards):
    """Per-shard partials of the plain version, combined by the port's
    combine_decode_stats, equal the JAX oracle's combine of the Pallas
    kernel's partials and the unsharded o / l (atol 2e-6, as
    test_kernels.py), including shards wholly past length."""
    B, H, Hkv, S, d = 2, 4, 2, 128, 32
    rng = np.random.default_rng(shards)
    q, k, v = _qkv(rng, B, H, Hkv, S, d)
    length = np.array([100, 20], np.int32)
    parts_t, parts_j = [], []
    for i in range(shards):
        lo, hi = i * S // shards, (i + 1) * S // shards
        ln = np.clip(length - lo, 0, hi - lo).astype(np.int32)
        args = (q, k[:, :, lo:hi], v[:, :, lo:hi], ln)
        parts_t.append(tref.decode_attention(*map(torch.as_tensor, args)))
        parts_j.append(pallas_flash_decode(*map(jnp.asarray, args),
                                           block_k=16))
    comb_t = tops.combine_decode_stats(
        *[torch.stack([p[i] for p in parts_t]) for i in range(3)])
    comb_j = jref.combine_decode_stats(
        *[jnp.stack([p[i] for p in parts_j]) for i in range(3)])
    o, m, l = jref.decode_attention(*map(jnp.asarray, (q, k, v, length)))
    full = np.asarray(o / jnp.maximum(l, 1e-30)[..., None])
    np.testing.assert_allclose(comb_t.numpy(), np.asarray(comb_j), atol=2e-6)
    np.testing.assert_allclose(comb_t.numpy(), full, atol=2e-6)


def _merge_in_split_order(o_p, m_p, l_p):
    """The merge of the split decode kernel (csrc/flash_decode.cu,
    merge_if_last) in plain torch: partials (n_split, ...) rescaled to the
    largest m and summed in split order; o stays unnormalized."""
    m_all = m_p.amax(0)
    m_use = torch.where(torch.isfinite(m_all), m_all, torch.zeros_like(m_all))
    o = torch.zeros_like(o_p[0])
    l = torch.zeros_like(l_p[0])
    for o_i, m_i, l_i in zip(o_p, m_p, l_p):
        w = torch.where(torch.isfinite(m_i), torch.exp(m_i - m_use),
                        torch.zeros_like(m_i))
        o = o + w[..., None] * o_i
        l = l + w * l_i
    return o, m_all, l


@pytest.mark.parametrize("chunk,lengths", [
    (16, [0, 1, 15, 16, 17, 40, 63, 64]),
    (64, [0, 1, 63, 64, 65, 100])])
def test_split_decode_partials_merge_to_one_pass(chunk, lengths):
    """The split kernel's arithmetic (B6): the cache (S = 64 or 100 keys,
    so the last range may be short) cut into ranges of `chunk` keys, the
    port's decode_attention over each range (ranges wholly past a row's
    length give m = -inf, l = 0, o = 0), merged in split order: (o, m, l)
    equal one decode_attention over the whole prefix (f32, 1e-6), length 0
    included, and o / l equals JAX's combine_decode_stats of the same
    per-range partials (atol 1e-6)."""
    B, H, Hkv, S, d = len(lengths), 4, 2, max(lengths), 32
    rng = np.random.default_rng(chunk)
    q, k, v = map(torch.as_tensor, _qkv(rng, B, H, Hkv, S, d))
    length = torch.tensor(lengths, dtype=torch.int32)
    parts = []
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        part_len = (length - lo).clamp(0, hi - lo).to(torch.int32)
        parts.append(tref.decode_attention(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                           part_len))
    o_p, m_p, l_p = (torch.stack([p[i] for p in parts]) for i in range(3))
    assert bool((m_p[-1, 0] == float("-inf")).all())   # past length 0
    o, m, l = _merge_in_split_order(o_p, m_p, l_p)
    o_w, m_w, l_w = tref.decode_attention(q, k, v, length)
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m, m_w, **tol)
    torch.testing.assert_close(l, l_w, **tol)
    torch.testing.assert_close(o, o_w, **tol)
    assert bool((o[0] == 0).all()) and bool((l[0] == 0).all())
    comb = jref.combine_decode_stats(*(jnp.asarray(x.numpy())
                                       for x in (o_p, m_p, l_p)))
    np.testing.assert_allclose((o / l.clamp(min=1e-30)[..., None]).numpy(),
                               np.asarray(comb), atol=1e-6)


@pytest.mark.parametrize("B,H,Hkv,W,hd", [(3, 4, 4, 40, 16),
                                          (2, 4, 2, 1100, 16),
                                          (4, 6, 2, 9, 32)])
def test_decode_body_matches_chunked_flash(B, H, Hkv, W, hd):
    """The port's one-device body of global-attention decode (flash
    partials of the cache's valid prefix, then o / l; the caller of B6)
    equals what the JAX decode path computes there:
    chunked_flash(q, ck, cv, causal=False, kv_len=pos + 1), whose kv chunks
    are 1024 wide (two chunks at W = 1100). f32, atol 1e-5, on either
    backend choice."""
    rng = np.random.default_rng(W + hd)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    ck = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    cv = rng.normal(size=(B, W, Hkv, hd)).astype(np.float32)
    pos = rng.integers(0, W, (B,)).astype(np.int32)
    pos[0] = W - 1
    want = jax.jit(lambda q, k, v, p: jlm.chunked_flash(
        q, k, v, causal=False, kv_len=p + 1))(
        *map(jnp.asarray, (q, ck, cv, pos)))
    for backend in (Backend.RPC, Backend.RDMA):
        got = tlm._decode_attn_distributed(
            *map(torch.as_tensor, (q, ck, cv, pos)), backend)
        assert got.shape == (B, 1, H, hd) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
