"""On the card: the CUDA kernels against their plain versions, and the
port's op streams on CUDA against the same streams on the CPU. Every test
here takes the `cuda_device` fixture, which skips it where torch sees no
card. The file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import am, hashtable as ht, queue as dq
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
