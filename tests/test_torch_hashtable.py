"""The slice as a whole, for the hash table: build a table in JAX, carry its
window into the port (repro_torch.convert), run one op stream through both
and compare every visible result (ok, probes, found, vals) and the final
window, bit for bit. Arms: RDMA fused and unfused (C_RW and C_W inserts,
C_R and C_RW finds, with and without coalescing) and RPC (insert-or-assign
and find through the active-message engine).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as jam
from repro.core import hashtable as jht
from repro.core.types import Promise as JPromise
from repro_torch import convert
from repro_torch.core import adaptive as tad
from repro_torch.core import am as tam
from repro_torch.core import hashtable as tht
from repro_torch.core.types import Promise
from torch_parity import jit, same, torch_one_thread, tt  # noqa: F401

P, NSLOTS, N = 4, 32, 8
# the JAX side runs jitted (its functions are tracer-safe): one compile per
# shape instead of one per primitive keeps these tests quick
j_insert = jit(jht.insert_rdma, "promise", "max_probes", "fused", "coalesce")
j_find = jit(jht.find_rdma, "promise", "max_probes", "fused", "coalesce")
j_insert_rpc = jit(jht.insert_rpc, "engine", "coalesce")
j_find_rpc = jit(jht.find_rpc, "engine", "coalesce")


def test_hash_mix_and_placement_match_numpy_and_jax():
    """The int64-masked mix against the uint32 numpy and jnp versions, on
    keys near 2**31 and 2**32 (as int32 bit patterns) and at random."""
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1,
                     2 ** 31 - 2, -2, 0x7FFF0000, -0x10000], np.int64)
    keys = np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31, 500)]
                          ).astype(np.int32)
    same(tht.hash_mix(tt(keys)), jht.hash_mix_np(keys).astype(np.int64))
    same(tht.hash_mix_np(keys), jht.hash_mix_np(keys))
    same(tht.hash_mix(tt(keys)),
         np.asarray(jht.hash_mix(jnp.asarray(keys))).astype(np.int64))
    for nranks, nslots in ((4, 32), (64, 2 ** 18), (3, 1000)):
        shape = SimpleNamespace(nranks=nranks, nslots=nslots)
        ot, st = tht._place(shape, tt(keys))
        oj, sj = jht.place_np(nranks, nslots, keys)
        same(ot, oj, "owner")
        same(st, sj, "start")
        on, sn = tht.place_np(nranks, nslots, keys)
        same(on, oj)
        same(sn, sj)


def _keys(seed, batches, vw, dup=False):
    """Distinct keys per batch (RDMA inserts are insert-only); dup=True
    repeats identical [key|val] rows inside a batch."""
    rng = np.random.default_rng(seed)
    ks = rng.choice(2 ** 20, size=batches * P * N, replace=False)
    ks = ks.reshape(batches, P, N).astype(np.int32) - 2 ** 19
    if dup:
        ks[:, :, 1] = ks[:, :, 0]
    vals = np.stack([ks * 3 + w for w in range(vw)], -1).astype(np.int32)
    return ks, vals


def _jax_table(ks, vals, vw, nslots=NSLOTS):
    """A JAX table after its first insert batch: the state both continue."""
    ht = jht.make_hashtable(P, nslots, vw)
    ht, _, _ = j_insert(ht, jnp.asarray(ks[0]), jnp.asarray(vals[0]))
    return ht


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("promise", ["CRW", "CW"])
def test_rdma_stream_matches_jax(fused, promise):
    vw = 2
    ks, vals = _keys(1 if fused else 2, 4, vw)
    hj = _jax_table(ks, vals, vw)
    htt = convert.hashtable_from_numpy(np.asarray(hj.win.data), NSLOTS, vw,
                                       device="cpu")
    for b in (1, 2, 3):
        hj, okj, prj = j_insert(hj, jnp.asarray(ks[b]),
                                jnp.asarray(vals[b]),
                                promise=JPromise[promise], fused=fused)
        htt, okt, prt = tht.insert_rdma(htt, tt(ks[b]), tt(vals[b]),
                                        promise=Promise[promise],
                                        fused=fused)
        same(okt, okj, f"ok batch {b}")
        same(prt, prj, f"probes batch {b}")
        same(convert.to_numpy(htt), hj.win.data, f"window batch {b}")
    # finds: half present, half absent, both promise levels
    q = np.concatenate([ks[1:3].reshape(-1)[: P * N // 2],
                        ks[:, :, 0].reshape(-1)[:P * N // 2] + 2 ** 21])
    q = np.random.default_rng(5).permutation(q).reshape(P, N).astype(np.int32)
    for fp in ("CR", "CRW"):
        hj, fj, vj = j_find(hj, jnp.asarray(q), promise=JPromise[fp],
                            fused=fused)
        htt, ft, vt = tht.find_rdma(htt, tt(q), promise=Promise[fp],
                                    fused=fused)
        same(ft, fj, f"found {fp}")
        same(vt, vj, f"vals {fp}")
        same(convert.to_numpy(htt), hj.win.data, f"window after {fp} find")


@pytest.mark.parametrize("fused", [True, False])
def test_rdma_coalesced_stream_matches_jax(fused):
    """Duplicate identical rows: fused shares one CoalescedPlan (a run
    claims one slot), unfused coalesces per phase."""
    vw = 1
    ks, vals = _keys(3, 3, vw, dup=True)
    hj = _jax_table(ks, vals, vw)
    htt = convert.hashtable_from_numpy(np.asarray(hj.win.data), NSLOTS, vw,
                                       device="cpu")
    for b in (1, 2):
        hj, okj, prj = j_insert(hj, jnp.asarray(ks[b]),
                                jnp.asarray(vals[b]), fused=fused,
                                coalesce=True)
        htt, okt, prt = tht.insert_rdma(htt, tt(ks[b]), tt(vals[b]),
                                        fused=fused, coalesce=True)
        same(okt, okj)
        same(prt, prj)
        same(convert.to_numpy(htt), hj.win.data)
    for fp in ("CR", "CRW"):
        hj, fj, vj = j_find(hj, jnp.asarray(ks[1]), promise=JPromise[fp],
                            fused=fused, coalesce=True)
        htt, ft, vt = tht.find_rdma(htt, tt(ks[1]), promise=Promise[fp],
                                    fused=fused, coalesce=True)
        same(ft, fj)
        same(vt, vj)
        same(convert.to_numpy(htt), hj.win.data)


@pytest.mark.parametrize("coalesce", [False, True])
def test_rpc_stream_matches_jax(coalesce):
    """Insert-or-assign through the AM engine: repeated keys across and
    inside batches update in place; a small table runs out of probe
    window; finds of present and absent keys."""
    vw, nslots = 1, 8
    ks, vals = _keys(4, 3, vw, dup=True)
    ks[2, :, 2:5] = ks[1, :, 2:5]                     # updates
    vals[2] += 1000
    hj = _jax_table(ks, vals, vw, nslots)
    ej = jam.AMEngine(P)
    jht.build_am_handlers(hj, ej)
    htt = convert.hashtable_from_numpy(np.asarray(hj.win.data), nslots, vw,
                                       device="cpu")
    et = tam.AMEngine(P)
    tht.build_am_handlers(htt, et)
    for b in (1, 2):
        hj, okj, prj = j_insert_rpc(hj, ej, jnp.asarray(ks[b]),
                                    jnp.asarray(vals[b]), coalesce=coalesce)
        htt, okt, prt = tht.insert_rpc(htt, et, tt(ks[b]), tt(vals[b]),
                                       coalesce=coalesce)
        same(okt, okj)
        same(prt, prj)
        same(convert.to_numpy(htt), hj.win.data)
    assert not bool(okt.all())       # the probe window ran out somewhere
    q = ks[:, :, :4].reshape(P, -1).copy()
    q[:, ::3] += 2 ** 21                               # absent keys
    fj, vj = j_find_rpc(hj, ej, jnp.asarray(q), coalesce=coalesce)
    ft, vt = tht.find_rpc(htt, et, tt(q), coalesce=coalesce)
    same(ft, fj)
    same(vt, vj)


def test_front_doors_and_valid_masks():
    """insert/find front doors with explicit backends and a valid mask;
    with no backend argument (AUTO) the adaptive chooser picks a
    one-sided arm and the result is that arm's."""
    vw = 1
    ks, vals = _keys(6, 2, vw)
    valid = np.random.default_rng(1).random((P, N)) > 0.3
    hj = _jax_table(ks, vals, vw)
    htt = convert.hashtable_from_numpy(np.asarray(hj.win.data), NSLOTS, vw,
                                       device="cpu")
    hj, okj, _ = j_insert(hj, jnp.asarray(ks[1]), jnp.asarray(vals[1]),
                          valid=jnp.asarray(valid))
    htt, okt, _ = tht.insert(htt, tt(ks[1]), tt(vals[1]), backend="rdma",
                             valid=tt(valid))
    same(okt, okj)
    same(convert.to_numpy(htt), hj.win.data)
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    jht.build_am_handlers(hj, ej)
    tht.build_am_handlers(htt, et)
    fj, vj = j_find_rpc(hj, ej, jnp.asarray(ks[1]), valid=jnp.asarray(valid))
    _, ft, vt = tht.find(htt, tt(ks[1]), backend="rpc", engine=et,
                         valid=tt(valid))
    same(ft, fj)
    same(vt, vj)
    a = tad.AdaptiveEngine(P)
    auto = tht.insert(htt, tt(ks[0]), tt(vals[0]), adaptive=a)
    arm = a.last_decision.arm
    assert arm in ("rdma", "rdma_fused")
    for x, y in zip(auto[1:] + (auto[0].win.data,), (
            lambda r: r[1:] + (r[0].win.data,))(tht.insert_rdma(
                htt, tt(ks[0]), tt(vals[0]), fused=arm == "rdma_fused"))):
        same(x, y)
    # the cache seam runs: a cached find (filling, then from the cache)
    # equals the uncached one
    from repro_torch.core import cache
    c = cache.BucketCache(P, NSLOTS, vw, capacity=64)
    want = tht.find_rdma(htt, tt(ks[1]), valid=tt(valid))[1:]
    for _ in range(2):
        for x, y in zip(tht.find_rdma(htt, tt(ks[1]), valid=tt(valid),
                                      cache=c)[1:], want):
            same(x, y)
    assert c.counters["hits"] > 0


def test_to_numpy_round_trip_and_devices():
    data = np.arange(P * NSLOTS * 3, dtype=np.int32).reshape(P, -1)
    ht = convert.hashtable_from_numpy(data, NSLOTS, 1, device="cpu")
    assert ht.win.data.dtype == torch.int32
    same(convert.to_numpy(ht), data)
    with pytest.raises(ValueError):
        convert.hashtable_from_numpy(data, NSLOTS, 2, device="cpu")
    fresh = tht.make_hashtable(2, 8, 1, device="cpu")
    assert fresh.win.data.device.type == "cpu"
    assert fresh.win.data.shape == (2, 24)
