"""The hot-bucket cache tier of the port (`repro_torch.core.cache`) on the
CPU: the version protocol, the zero-exchange property of cache hits, and
the cached arm of the chooser.

Parity with the JAX package, bit for bit (every value is an integer or a
count): `routing.miss_subset_plan`, and one mixed insert / find stream
through both packages' `AdaptiveEngine` with a cache, on every insert arm
(results, windows, the Decisions' cached flag and `cache.stats()`, which
pins that the publishes of a probe loop reach neither cache). The rest is
tests/test_cache.py held against the port's own oracle (a dict, the
uncached arms) instead of the JAX streams, with two changes: the
randomized sequences do not require a hit at 3 rounds (the JAX test's
`hits > 0` fails on some seeds there), and the tracer test becomes a
direct `invalidate_all` test (the port has no tracer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import am as jam
from repro.core import cache as jcache
from repro.core import hashtable as jht
from repro.core import routing as jrouting
from repro_torch.core import adaptive as ad_mod
from repro_torch.core import am as am_mod
from repro_torch.core import cache as cache_mod
from repro_torch.core import faults as flt
from repro_torch.core import hashtable as ht_mod
from repro_torch.core import routing
from repro_torch.core import window as win_mod
from torch_parity import npy, same, torch_one_thread, tt  # noqa: F401

P = 4
VW = 1
NSLOTS = 64


def _val_of(keys):
    return ((np.asarray(keys) * 31 + 7) & 0x7FFFFF)[..., None].astype(
        np.int32)


class ExchangeCounter:
    """Counts exchanges by role through the routing hook (each exchange
    calls it twice: role_pre and role_post)."""

    def __init__(self):
        self.roles = []

    def hook(self, x, role):
        if role.endswith("_pre"):
            self.roles.append(role[:-4])
        return x

    def run(self, fn):
        self.roles = []
        with routing.sharding_hook(self.hook):
            fn()
        return len(self.roles)


def _fresh(rng, shape, used):
    out = np.empty(int(np.prod(shape)), np.int64)
    i = 0
    while i < out.size:
        k = int(rng.integers(1, 1 << 30))
        if k not in used:
            used.add(k)
            out[i] = k
            i += 1
    return out.reshape(shape).astype(np.int32)


def _table(nslots=NSLOTS):
    return ht_mod.make_hashtable(P, nslots, VW, device="cpu")


def _engine(nslots=NSLOTS, capacity=256, max_probes=8):
    eng = ad_mod.AdaptiveEngine(P, arms=("rdma_fused",))
    eng.attach_cache(cache_mod.BucketCache(P, nslots, VW, capacity=capacity,
                                           max_probes=max_probes))
    return eng


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------
def test_miss_subset_plan_matches_jax():
    """With a hit mask, the plan and runs of the batch without the hit
    rows; with none, `coalesce_plan` itself."""
    rng = np.random.default_rng(7)
    n = 12
    dst = rng.integers(0, P, (P, n)).astype(np.int32)
    off = rng.integers(0, 5, (P, n)).astype(np.int32)
    valid = rng.random((P, n)) > 0.2
    hit = rng.random((P, n)) > 0.6
    for h in (hit, None):
        pj = jrouting.miss_subset_plan(
            jnp.asarray(dst), jnp.asarray(off),
            None if h is None else jnp.asarray(h), valid=jnp.asarray(valid),
            cap=n)
        pt = routing.miss_subset_plan(tt(dst), tt(off),
                                      None if h is None else tt(h),
                                      valid=tt(valid), cap=n)
        for f in ("dst_eff", "op_slot", "op_ok", "mask", "dropped"):
            same(getattr(pt.plan, f), getattr(pj.plan, f), f)
        same(pt.co.rep, pj.co.rep)
        same(pt.co.pos, pj.co.pos)
    bare = routing.coalesce_plan(tt(dst), tt(off), valid=tt(valid & ~hit),
                                 cap=n)
    pt = routing.miss_subset_plan(tt(dst), tt(off), tt(hit), valid=tt(valid),
                                  cap=n)
    same(pt.plan.mask, bare.plan.mask)


def _mixed_stream(pkg, insert_arm, seed=3, rounds=2):
    """Inserts on `insert_arm`, then two cached CR finds of old, duplicate
    and absent keys, each round; returns (outputs, window, stats, the
    Decisions' cached flags)."""
    rng = np.random.default_rng(seed)
    used: set = set()
    if pkg == "jax":
        eng = jad.AdaptiveEngine(P, am_engine=jam.AMEngine(P))
        eng.attach_cache(jcache.BucketCache(P, 128, VW, capacity=256))
        ht, arr = jht.make_hashtable(P, 128, VW), jnp.asarray
    else:
        eng = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        eng.attach_cache(cache_mod.BucketCache(P, 128, VW, capacity=256))
        ht, arr = _table(128), torch.as_tensor
    outs, inserted = [], []
    for _ in range(rounds):
        k = _fresh(rng, (P, 3), used)
        inserted.append(k)
        eng.force_arm = insert_arm
        ht, ok, _ = eng.ht_insert(ht, arr(k), arr(_val_of(k)))
        eng.force_arm = "rdma_fused"
        old = inserted[int(rng.integers(0, len(inserted)))]
        probe = np.concatenate([old, old[:, :1], _fresh(rng, (P, 2), used)],
                               axis=1)
        for _ in range(2):
            ht, f, v = eng.ht_find(ht, arr(probe))
            outs += [npy(f), npy(v)]
        outs.append(npy(ok))
    return outs, npy(ht.win.data), eng.cache.stats(), [
        d.cached for d in eng.log]


@pytest.mark.parametrize("arm", ["rdma", "rdma_fused", "am", "am_pt"])
def test_mixed_stream_matches_jax(arm):
    """Results, window, cached decisions and every cache counter (hits,
    misses, fills, fill_drops, invalidations, write_tick, epoch) equal the
    JAX package's. The unfused insert's final FXOR publish reaches the
    cache in both packages; the fused insert's, inside its probe loop, in
    neither."""
    out, win, stats, cached = _mixed_stream("torch", arm)
    jout, jwin, jstats, jcached = _mixed_stream("jax", arm)
    for i, (a, b) in enumerate(zip(out, jout)):
        same(a, b, (arm, i))
    same(win, jwin, (arm, "window"))
    assert stats == jstats, arm
    assert cached == jcached, arm
    assert stats["hits"] > 0 and stats["fills"] > 0, stats
    assert stats["write_tick"] == (4 if arm == "rdma" else 2), stats
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Zero-exchange pins
# ---------------------------------------------------------------------------
def test_all_hit_find_issues_zero_exchanges():
    """A fully cached find batch never touches the network."""
    rng = np.random.default_rng(0)
    used: set = set()
    eng = _engine()
    ht = _table()
    keys = _fresh(rng, (P, 8), used)
    ht, ok, _ = eng.ht_insert(ht, keys, _val_of(keys))
    assert bool(ok.all())
    ht, f1, v1 = eng.ht_find(ht, keys)     # miss pass: fills the cache
    assert bool(f1.all())
    ctr = ExchangeCounter()
    n = ctr.run(lambda: eng.ht_find(ht, keys))
    assert n == 0, f"all-hit find issued {n} exchanges: {ctr.roles}"
    ht, f2, v2 = eng.ht_find(ht, keys)
    same(f2, f1)
    same(v2, v1)


def test_mixed_batch_plans_only_the_miss_subset():
    """A half-cached batch pays the exchanges of a batch of its misses."""
    rng = np.random.default_rng(1)
    used: set = set()
    eng = _engine()
    ht = _table()
    warm = _fresh(rng, (P, 4), used)
    cold = _fresh(rng, (P, 4), used)
    both = np.concatenate([warm, cold], axis=1)
    ht, _, _ = eng.ht_insert(ht, both, _val_of(both))
    ht, _, _ = eng.ht_find(ht, warm)       # cache the warm half
    ht, _, _ = eng.ht_find(ht, warm)       # confirmed hot
    assert eng.cache.last_hit_rate == 1.0
    ctr = ExchangeCounter()
    mixed = ctr.run(lambda: eng.ht_find(ht, both))
    eng.cache.invalidate_all()
    cold_only = ctr.run(lambda: eng.ht_find(ht, cold))
    assert mixed == cold_only > 0, (mixed, cold_only)


def test_cache_events_logged_without_extra_phases():
    """The phase log carries cache_hit events for cached finds and no
    routed phase for an all-hit batch."""
    rng = np.random.default_rng(2)
    used: set = set()
    eng = _engine()
    ht = _table()
    keys = _fresh(rng, (P, 6), used)
    ht, _, _ = eng.ht_insert(ht, keys, _val_of(keys))
    ht, _, _ = eng.ht_find(ht, keys)
    win_mod.drain_phase_log()
    eng.ht_find(ht, keys)                  # all-hit
    roles = [r for r, _, _ in win_mod.drain_phase_log()]
    assert "cache_hit" in roles
    assert not any(r.startswith(("get", "ht_find", "fao")) for r in roles), (
        f"all-hit find logged routed phases: {roles}")


def test_loop_publishes_skip_the_cache():
    """A publish flip inside a probe loop (`faults.loop_scope`, where the
    JAX package's offsets are tracers) leaves the cache alone; the same
    flip outside a loop bumps its slot and the write tick."""
    c = cache_mod.BucketCache(P, NSLOTS, VW, capacity=64)
    win = win_mod.make_window(P, NSLOTS * (2 + VW), device="cpu")
    dst = torch.zeros((P, 2), dtype=torch.int32)
    off = torch.tensor([[0, 3]] * P, dtype=torch.int32)
    vals = torch.ones((P, 2, 1 + VW), dtype=torch.int32)
    with win_mod.cache_scope(c), flt.loop_scope(dst, ("cas_put_pub",)):
        win_mod.rdma_cas_put_publish(win, dst, off, 0, 1, off + 1, vals, 3)
    assert c.write_tick == 0 and not c.versions.any()
    with win_mod.cache_scope(c):
        win_mod.rdma_cas_put_publish(win, dst, off, 0, 1, off + 1, vals, 3)
    assert c.write_tick == 1
    assert c.versions[0, 0] == P and c.versions[0, 1] == P


# ---------------------------------------------------------------------------
# Invalidation ordering
# ---------------------------------------------------------------------------
def test_stale_version_eviction():
    """A bumped cached slot forces the next lookup to miss, evict and
    refetch."""
    rng = np.random.default_rng(3)
    used: set = set()
    eng = _engine()
    c = eng.cache
    ht = _table()
    keys = _fresh(rng, (P, 4), used)
    ht, _, _ = eng.ht_insert(ht, keys, _val_of(keys))
    ht, _, _ = eng.ht_find(ht, keys)
    ht, f, v = eng.ht_find(ht, keys)
    assert c.last_hit_rate == 1.0
    c.versions += 1                        # every cached entry now stale
    before = c.counters["stale_evicted"]
    ht, f, v = eng.ht_find(ht, keys)
    assert c.last_hit_rate == 0.0
    assert c.counters["stale_evicted"] > before
    assert bool(f.all())                   # refetched from the table
    same(v, _val_of(keys))


def test_write_then_read_same_round_sees_the_write():
    """Insert keys, then find the same keys at once: the pre-insert cache
    state must not answer."""
    rng = np.random.default_rng(4)
    used: set = set()
    eng = _engine()
    ht = _table()
    k1 = _fresh(rng, (P, 4), used)
    ht, _, _ = eng.ht_insert(ht, k1, _val_of(k1))
    ht, _, _ = eng.ht_find(ht, k1)         # warm
    k2 = _fresh(rng, (P, 4), used)
    ht, ok, _ = eng.ht_insert(ht, k2, _val_of(k2))
    assert bool(ok.all())
    ht, f, v = eng.ht_find(ht, k2)
    assert bool(f.all())
    same(v, _val_of(k2))


def test_racing_write_drops_deferred_fill():
    """A fill queued before a write (tick snapshot) is dropped at drain,
    not stamped fresh."""
    c = cache_mod.BucketCache(P, NSLOTS, VW, capacity=64)
    keys = np.arange(1, 1 + P * 4, dtype=np.int32).reshape(P, 4)
    look = c.lookup(keys)
    assert look is not None and not look.hit.any()
    host = [np.zeros((P, 4), np.int32), np.ones((P, 4), bool),
            np.ones((P, 4, VW), np.int32)]
    c._pending.append((look.tick, look.keys, look.miss, host, []))
    c.on_insert_keys(keys)                 # the racing write
    c.drain_fills(force=True)
    assert c.counters["fill_drops"] >= 1
    assert not c.lookup(keys).hit.any(), "racing fill was stamped fresh"


def test_write_heavy_stream_disables_cache_reads():
    """A write-heavy stream pushes the write EWMA past the threshold and
    cache reads switch off; a read-heavy stretch turns them back on."""
    rng = np.random.default_rng(5)
    used: set = set()
    eng = _engine(nslots=512)
    ht = _table(512)
    for _ in range(12):
        k = _fresh(rng, (P, 2), used)
        ht, _, _ = eng.ht_insert(ht, k, _val_of(k))
    assert eng.write_ewma > eng.WRITE_HEAVY
    assert not eng.cache_reads_on()
    k = _fresh(rng, (P, 2), used)
    ht, _, _ = eng.ht_insert(ht, k, _val_of(k))
    ht, f, v = eng.ht_find(ht, k)
    assert not eng.last_decision.cached
    assert bool(f.all())
    for _ in range(12):
        ht, _, _ = eng.ht_find(ht, k)
    assert eng.cache_reads_on()
    assert eng.last_decision.cached


def test_invalidate_all_flushes_entries_and_pending_fills():
    """`invalidate_all` drops every entry and pending fill, opens a new
    epoch and bumps the write tick (without it, only the epoch)."""
    c = cache_mod.BucketCache(P, NSLOTS, VW, capacity=64)
    keys = np.arange(1, 1 + P * 4, dtype=np.int32).reshape(P, 4)
    look = c.lookup(keys)
    c.note_fill(look, torch.zeros((P, 4), dtype=torch.int32),
                torch.ones((P, 4), dtype=torch.bool),
                torch.ones((P, 4, VW), dtype=torch.int32))
    assert c.lookup(keys).hit.all()
    look = c.lookup(keys + 100)
    c._pending.append((look.tick, look.keys, look.miss,
                       [np.zeros((P, 4), np.int32), np.ones((P, 4), bool),
                        np.ones((P, 4, VW), np.int32)], []))
    epoch, tick, drops = c.epoch, c.write_tick, c.counters["fill_drops"]
    c.invalidate_all()
    assert c.epoch == epoch + 1 and c.write_tick == tick + 1
    assert c.counters["fill_drops"] == drops + 1 and not c._pending
    assert c.stats()["entries"] == 0
    assert not c.lookup(keys).hit.any()
    c.invalidate_all(bump_tick=False)
    assert c.epoch == epoch + 2 and c.write_tick == tick + 1


# ---------------------------------------------------------------------------
# Randomized mixed read/write conformance (oracle == uncached == cached)
# ---------------------------------------------------------------------------
def _mixed_sequence(seed: int, rounds: int = 5):
    rng = np.random.default_rng(seed)
    used: set = set()
    cached = _engine(nslots=128)
    ht_c, ht_u = _table(128), _table(128)
    oracle = {}
    inserted = []
    for _ in range(rounds):
        k = _fresh(rng, (P, 3), used)
        inserted.append(k)
        ht_c, okc, _ = cached.ht_insert(ht_c, k, _val_of(k))
        ht_u, oku, _ = ht_mod.insert_rdma(ht_u, k, _val_of(k))
        for key in k.ravel().tolist():
            oracle[key] = (key * 31 + 7) & 0x7FFFFF
        same(okc, oku)
        old = inserted[int(rng.integers(0, len(inserted)))]
        probe = np.concatenate([old, old[:, :1], _fresh(rng, (P, 2), used)],
                               axis=1)
        ht_c, fc, vc = cached.ht_find(ht_c, probe)
        ht_u, fu, vu = ht_mod.find_rdma(ht_u, probe)
        same(fc, fu)
        same(vc, vu)
        exp_f = np.vectorize(lambda x: x in oracle)(probe)
        same(fc, exp_f)
        same(npy(vc)[..., 0], np.where(exp_f, (probe * 31 + 7) & 0x7FFFFF,
                                       0))
    return cached.cache.counters


def test_mixed_read_write_sequences_conformant():
    for seed in (0, 1, 2):
        counters = _mixed_sequence(seed)
        assert counters["hits"] > 0, "sequence never hit the cache"


@pytest.mark.parametrize("seed", [227, 4242, 9001])
def test_mixed_sequences_property(seed):
    """Short sequences at other seeds (227 is one where the JAX test's
    `hits > 0` fails at 3 rounds): oracle == uncached == cached."""
    _mixed_sequence(seed, rounds=3)
