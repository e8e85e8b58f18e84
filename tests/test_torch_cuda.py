"""On the card: the CUDA kernels against their plain versions, the port's
op streams on CUDA against the same streams on the CPU, and a reduced
model's decode steps on CUDA against the CPU. Every test
here takes the `cuda_device` fixture, which skips it where torch sees no
card. The file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import am, hashtable as ht, queue as dq
from repro_torch.models import lm
from repro_torch.core.types import Promise
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from torch_parity import (amo_inputs, cuda_device, probe_table,  # noqa: F401
                          same)


def _on(dev, *xs):
    return [torch.as_tensor(np.asarray(x)).to(dev) for x in xs]


def test_owner_lane_kernels_match_plain_versions(cuda_device):
    rng = np.random.default_rng(11)
    local, ops, mask = _on(cuda_device, *amo_inputs(rng, 4, 64, 96, 8))
    for x, y in zip(kops.amo_apply(local, ops, mask),
                    kref.amo_apply(local, ops, mask)):
        same(x, y)
    for V, G in ((2, 3), (0, 1)):
        desc = np.concatenate([
            np.stack([rng.integers(-2, 10, (4, 96)),
                      rng.integers(0, 12, (4, 96)),
                      rng.integers(0, 4, (4, 96)),
                      rng.integers(0, 10, (4, 96)),
                      rng.integers(-3, 67, (4, 96)),
                      rng.integers(-5, 5, (4, 96))], -1),
            rng.integers(0, 99, (4, 96, V))], -1)
        (d,) = _on(cuda_device, desc.astype(np.int32))
        for x, y in zip(kops.fused_apply(local, d, mask, reply_width=1 + G),
                        kref.fused_apply(local, d, mask, reply_width=1 + G)):
            same(x, y)


@pytest.mark.parametrize("fill", [0.6, 1.0])
def test_handler_kernels_match_plain_versions(cuda_device, fill):
    rng = np.random.default_rng(12)
    table, starts, keys, vals, mask = _on(
        cuda_device, probe_table(rng, 3, 32, 2, fill, key_span=12),
        rng.integers(0, 32, (3, 40)).astype(np.int32),
        rng.integers(0, 12, (3, 40)).astype(np.int32),
        rng.integers(0, 9, (3, 40, 2)).astype(np.int32),
        rng.random((3, 40)) > 0.2)
    kw = dict(nslots=32, rec_w=4, max_probes=8)
    for x, y in zip(kops.hash_find(table, starts, keys, mask, **kw),
                    kref.hash_find(table, starts, keys, mask, **kw)):
        same(x, y)
    for x, y in zip(kops.hash_insert(table, starts, keys, vals, mask, **kw),
                    kref.hash_insert(table, starts, keys, vals, mask, **kw)):
        same(x, y)


def _streams(dev):
    """Hash-table inserts and finds on every arm, queue pushes and pops on
    both, at P = 4; returns every reply and window."""
    rng = np.random.default_rng(13)
    P, n = 4, 16
    keys = torch.as_tensor(rng.choice(2 ** 20, (2, P, n), replace=False)
                           .astype(np.int32), device=dev)
    vals = (keys * 5)[..., None]
    out = []
    for arm in ("fused", "unfused", "rpc"):
        t = ht.make_hashtable(P, 64, 1, device=dev)
        eng = am.AMEngine(P)
        ht.build_am_handlers(t, eng)
        for b in range(2):
            if arm == "rpc":
                t, ok, pr = ht.insert_rpc(t, eng, keys[b], vals[b])
                found, v = ht.find_rpc(t, eng, keys[b] ^ (b << 21))
            else:
                t, ok, pr = ht.insert_rdma(t, keys[b], vals[b],
                                           fused=arm == "fused")
                t, found, v = ht.find_rdma(t, keys[b] ^ (b << 21),
                                           promise=Promise.CRW,
                                           fused=arm == "fused")
            out += [ok, pr, found, v, t.win.data]
    for arm in ("rdma", "rpc"):
        q = dq.make_queue(P, 1, 128, 2, device=dev)
        eng = am.AMEngine(P)
        dq.build_am_handlers(q, eng)
        items = torch.stack([keys[0], keys[1]], -1)
        if arm == "rpc":
            q, ok = dq.push_rpc(q, eng, items)
            q, got, v = dq.pop_rpc(q, eng, n)
        else:
            q, ok = dq.push_rdma(q, items)
            q, got, v = dq.pop_rdma(q, n, promise=Promise.CRW)
        out += [ok, got, v, q.win.data]
    return [x.cpu() for x in out]


def test_streams_on_cuda_equal_cpu(cuda_device):
    for g, c in zip(_streams(cuda_device), _streams("cpu")):
        same(g, c)


@pytest.mark.parametrize("T,E", [(1, 64), (48, 64), (300, 7), (6144, 64)])
def test_moe_dispatch_kernel_matches_plain_version(cuda_device, T, E):
    """Bit for bit, ids outside [0, E) included (they follow the plain
    version: no count, the wrapped column for [-E, 0), else INT32_MIN)."""
    rng = np.random.default_rng(T + E)
    ids = rng.integers(0, E, T)
    bad = rng.random(T) < 0.1
    ids[bad] = rng.integers(-2 * E, 2 * E, int(bad.sum()))
    (x,) = _on(cuda_device, ids.astype(np.int32))
    for a, b in zip(kops.moe_dispatch(x, n_experts=E),
                    kref.moe_dispatch(x, E)):
        same(a, b)


@pytest.mark.parametrize("g,dtype", [(1, torch.float32), (8, torch.float32),
                                     (1, torch.bfloat16), (3, torch.bfloat16)])
def test_flash_decode_kernel_matches_plain_version(cuda_device, g, dtype):
    """On a (B, W, Hkv, d) cache read through a transposed view, lengths
    0, 1, W and one not a multiple of the tile. o / l within 1e-4
    relative (f32 math over bf16 or f32 inputs, another summation order
    and an online softmax), m within 1e-5, l within 1e-4 relative."""
    rng = np.random.default_rng(g)
    B, Hkv, W, d = 4, 2, 200, 128
    q, ck, cv = _on(cuda_device, rng.normal(size=(B, Hkv * g, d)),
                    rng.normal(size=(B, W, Hkv, d)),
                    rng.normal(size=(B, W, Hkv, d)))
    q, ck, cv = q.to(dtype), ck.to(dtype), cv.to(dtype)
    length = torch.tensor([0, 1, W, 131], dtype=torch.int32,
                          device=cuda_device)
    args = (q, ck.transpose(1, 2), cv.transpose(1, 2), length)
    o, m, l = kops.flash_decode(*args)
    o_r, m_r, l_r = kref.decode_attention(*args)
    torch.testing.assert_close(m, m_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-4, atol=0)
    torch.testing.assert_close(o / l.clamp(min=1e-30)[..., None],
                               o_r / l_r.clamp(min=1e-30)[..., None],
                               rtol=1e-4, atol=1e-5)
    assert bool((o[0] == 0).all()) and bool((l[0] == 0).all())


def test_reduced_model_decode_on_cuda_equals_cpu(cuda_device):
    """Reduced deepseek-moe-16b (f32), the same weights on both devices,
    6 teacher-forced decode steps: logits within 1e-4 (f32 products in
    another order; TF32 off) and the same greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("deepseek-moe-16b").reduced()
    cpu = lm.init_lm(cfg, seed=5, device="cpu")
    gpu = lm.init_lm(cfg, seed=5, device="cpu").to(cuda_device)
    rng = np.random.default_rng(5)
    states = [lm.init_decode_state(cfg, 4, 8, device=d)
              for d in ("cpu", cuda_device)]
    for _ in range(6):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 4).astype(np.int32))
        lc, states[0] = lm.decode_step(cpu, states[0], tok)
        lg, states[1] = lm.decode_step(gpu, states[1], tok.to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        same(lg.argmax(-1), lc.argmax(-1))
