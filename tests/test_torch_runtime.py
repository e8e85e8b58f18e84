"""The port's runtime, data pipeline and training driver on the CPU:
checkpoints (atomic manifests, crash safety, GC, the write-behind
writer), the straggler monitor, elastic re-hash and the train driver's
bit-exact restart, as tests/test_runtime.py holds the JAX package's; the
synthetic data, the queued pipeline and the re-hash against the JAX
package (bit for bit: int32 data and windows); and the straggler bridge
and elastic re-hash tests of tests/test_faults.py that waited for these
modules, on the port's adaptive engine and fault plane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import hashtable as jht
from repro.core.types import Promise as JPromise
from repro.data import pipeline as jdata
from repro.runtime import elastic as jelastic
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import adaptive as ad_mod
from repro_torch.core import am as am_mod
from repro_torch.core import faults as flt
from repro_torch.core import hashtable as ht_mod
from repro_torch.core.types import Promise
from repro_torch.data import pipeline as tdata
from repro_torch.runtime import checkpoint as ck
from repro_torch.runtime import elastic
from repro_torch.runtime.straggler import StragglerMonitor
from torch_parity import same, torch_one_thread  # noqa: F401

P, VW, NSLOTS = 4, 2, 128


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones((5,), dtype=torch.int32), torch.zeros((2, 2))]}


def _leaves(t):
    return ck.tree_flatten(t)[0]


# ---------------------------------------------------------------------------
# tests/test_runtime.py, on the port
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ck.save_checkpoint(str(tmp_path), 7, t)
    assert ck.latest_step(str(tmp_path)) == 7
    t2 = ck.load_checkpoint(str(tmp_path), 7, t)
    for a, b in zip(_leaves(t), _leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_crash_safety(tmp_path):
    """A .tmp (simulated mid-write crash) is never considered complete."""
    t = _tree()
    ck.save_checkpoint(str(tmp_path), 5, t)
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "leaf_0.npy").write_bytes(b"partial")
    assert ck.latest_step(str(tmp_path)) == 5
    ck.gc_checkpoints(str(tmp_path), keep=3)
    assert not (tmp_path / "step_9.tmp").exists()


def test_checkpoint_gc_keeps_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save_checkpoint(str(tmp_path), s, t)
    ck.gc_checkpoints(str(tmp_path), keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert not (tmp_path / "step_1").exists()
    assert (tmp_path / "step_4").exists()


def test_async_checkpointer(tmp_path):
    t = _tree()
    acp = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20):
        acp.submit(s, t)
    acp.wait()
    acp.close()
    assert ck.latest_step(str(tmp_path)) == 20
    t2 = ck.load_checkpoint(str(tmp_path), 20, t)
    assert torch.equal(t2["a"], t["a"])


def test_straggler_monitor_flags_slow_and_dead():
    mon = StragglerMonitor(n_hosts=4, threshold=2.0, patience=2,
                           dead_after=3)
    for step in range(6):
        for h in range(4):
            if h == 3 and step >= 2:
                continue                    # host 3 dies at step 2
            dur = 1.0 if h != 1 else 5.0    # host 1 is slow
            mon.heartbeat(h, step, dur)
        mon.classify()
    plan = mon.plan()
    assert plan is not None
    assert 3 in plan["evict"]
    assert 1 in plan["evict"]
    assert 0 in plan["survivors"] and 2 in plan["survivors"]


def test_straggler_healthy_cluster_no_plan():
    mon = StragglerMonitor(n_hosts=4)
    for step in range(5):
        for h in range(4):
            mon.heartbeat(h, step, 1.0 + 0.01 * h)
        mon.classify()
    assert mon.plan() is None


def test_elastic_rehash_preserves_contents():
    """Shrink the DS layer 4 -> 2 virtual ranks: every live key survives."""
    keys = torch.as_tensor(np.random.default_rng(0).permutation(5000)[
        :P * 6].reshape(P, 6) + 1, dtype=torch.int32)
    vals = torch.stack([keys * 2], dim=-1)
    ht = ht_mod.make_hashtable(P, 64, 1, device="cpu")
    ht, ok, _ = ht_mod.insert_rdma(ht, keys, vals, promise=Promise.CW)
    assert bool(ok.all())
    ht2 = elastic.rehash_table(ht, new_nranks=2)
    assert ht2.nranks == 2
    k2 = keys.reshape(2, -1)
    ht2, found, got = ht_mod.find_rdma(ht2, k2, promise=Promise.CR,
                                       max_probes=16)
    assert bool(found.all())
    assert torch.equal(got[..., 0], k2 * 2)


def test_train_restart_bit_exact(tmp_path):
    """kill-and-restore through the port's driver on the CPU: 6 straight
    steps == 3 steps + restart from the checkpoint + 3 steps (rtol 1e-5,
    as the JAX package's test; the CPU runs are deterministic)."""
    from repro_torch.launch import train as train_mod

    base = ["--arch", "smollm-135m", "--reduced", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--total-steps", "6",
            "--device", "cpu"]
    l_straight = train_mod.main(base + ["--steps", "6"])
    ck1 = str(tmp_path / "ck")
    train_mod.main(base + ["--steps", "3", "--ckpt", ck1,
                           "--ckpt-every", "3"])
    l_resumed = train_mod.main(base + ["--steps", "6", "--ckpt", ck1,
                                       "--ckpt-every", "100"])
    assert len(l_resumed) == 3
    np.testing.assert_allclose(l_straight[3:], l_resumed, rtol=1e-5)


def test_moe_train_state_roundtrip_bit_for_bit(tmp_path):
    """Reduced deepseek-moe-16b after one AdamW step (its stacked expert
    leaves, router and shared experts, both moments and the count) through
    AsyncCheckpointer and back into a fresh model and optimizer state:
    every leaf equal bit for bit, as chip_smoke.py's train phases check at
    full width."""
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm
    from repro_torch.runtime import AsyncCheckpointer

    cfg = treg.get("deepseek-moe-16b").reduced()
    init_fn, train_step = steps.make_train_step(cfg, lr=1e-3, warmup=1,
                                                total_steps=4)
    model = lm.init_lm(cfg, 0, "cpu")
    opt = init_fn(model)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 2, 16)).astype(np.int32))
    model, opt, _ = train_step(model, opt, {"tokens": toks}, 0)
    writer = AsyncCheckpointer(str(tmp_path), keep=1)
    writer.submit(1, train_mod.state_tree(model, opt))
    writer.close()
    fresh = lm.init_lm(cfg, 1, "cpu")
    fresh_opt = init_fn(fresh)
    train_mod.restore_state(str(tmp_path), ck.latest_step(str(tmp_path)),
                            fresh, fresh_opt)
    want = _leaves(train_mod.state_tree(model, opt))
    got = _leaves(train_mod.state_tree(fresh, fresh_opt))
    assert len(got) == len(want)
    assert any(a.dim() == 3 for a in want)          # the stacked experts
    assert int(fresh_opt["count"]) == 1
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        # compared as bytes: -0.0 and 0.0, or two NaNs, are not equal bits
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# The port's own: bfloat16 leaves, restore onto a device
# ---------------------------------------------------------------------------
def test_bfloat16_leaves_restore_bit_for_bit(tmp_path):
    """numpy has no bfloat16: such a leaf is saved as its int16 bits and
    comes back as the same bfloat16 tensor, placed by restore_sharded."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    tree = ([x, torch.zeros(2, dtype=torch.bfloat16)],
            {"count": torch.tensor(3, dtype=torch.int32)})
    ck.save_checkpoint(str(tmp_path), 1, tree)
    back = ck.restore_sharded(str(tmp_path), 1, tree, "cpu")
    assert back[0][0].dtype == torch.bfloat16
    assert torch.equal(back[0][0].view(torch.int16), x.view(torch.int16))
    assert int(back[1]["count"]) == 3
    assert elastic.reshard_tree(back, "cpu")[0][0].device.type == "cpu"


# ---------------------------------------------------------------------------
# Data pipeline against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step,host", [(0, 0), (7, 3)])
def test_synthetic_lm_matches_jax(step, host):
    """SyntheticLM.batch is numpy in both packages: bit for bit; and
    train_batch gives the same (accum, microbatch, seq) tokens."""
    jd = jdata.SyntheticLM(vocab=1000, seq_len=33, seed=5)
    td = tdata.SyntheticLM(vocab=1000, seq_len=33, seed=5)
    np.testing.assert_array_equal(td.batch(step, host, 6),
                                  jd.batch(step, host, 6))
    cfg = treg.get("smollm-135m").reduced()
    jt = jd.train_batch(cfg, JShapeSpec("s", 33, 6, "train", 3), step, host)
    tt = td.train_batch(cfg, ShapeSpec("s", 33, 6, "train", 3), step, host,
                        device="cpu")
    assert tuple(tt["tokens"].shape) == (3, 2, 33)
    same(tt["tokens"], jt["tokens"])


def test_queued_pipeline_matches_jax():
    """Descriptors for 5 steps x 3 hosts pushed under C_W by one producer
    and popped under C_R, twice, through the port's QueuedPipeline (its
    default AUTO front door): the same pushes, pops and values as the JAX
    package's queue given JAX's QueuedPipeline descriptors on its rdma
    arm, jitted. Every arm gives the same visible results (the
    conformance contract AUTO relies on); JAX's eager AUTO takes about
    30 s here."""
    import jax
    from repro.core import queue as jq
    tp = tdata.QueuedPipeline(P, host=1, capacity=64, device="cpu")
    descs = np.array([[s, h, s * 3 + h] for s in range(5) for h in range(3)],
                     np.int32)
    per = -(-len(descs) // P)
    vals = np.concatenate([descs, np.zeros((per * P - len(descs), 3),
                                           np.int32)]).reshape(P, per, 3)
    valid = np.arange(per * P).reshape(P, per) < len(descs)
    jqueue = jq.make_queue(P, host=1, capacity=64, val_words=3)
    jqueue, jok = jax.jit(lambda q, v, m: jq.push_rdma(
        q, v, promise=JPromise.CW, valid=m))(jqueue, jnp.asarray(vals),
                                             jnp.asarray(valid))
    same(tp.produce(range(5), 3), jok)
    jpop = jax.jit(lambda q: jq.pop_rdma(q, 3, promise=JPromise.CR))
    for _ in range(2):
        tg, tv = tp.consume(3)
        jqueue, jg, jv = jpop(jqueue)
        same(tg, jg)
        same(tv, jv)


def test_rehash_table_matches_jax():
    """rehash_table 4 -> 8 ranks through the port's insert_rdma gives the
    JAX package's window (jitted) bit for bit."""
    rng = np.random.default_rng(21)
    keys = rng.choice(np.arange(1, 5000), size=48, replace=False).reshape(
        P, -1).astype(np.int32)
    vals = np.stack([keys * 3, keys + 1], -1).astype(np.int32)
    import jax
    jt = jht.make_hashtable(P, NSLOTS, VW)
    jt, _, _ = jax.jit(lambda t, k, v: jht.insert_rdma(
        t, k, v, promise=JPromise.CW))(jt, jnp.asarray(keys),
                                       jnp.asarray(vals))
    tt = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
    tt, _, _ = ht_mod.insert_rdma(tt, torch.as_tensor(keys),
                                  torch.as_tensor(vals), promise=Promise.CW)
    same(tt.win.data, jt.win.data)
    same(elastic.rehash_table(tt, 8).win.data,
         jax.jit(lambda t: jelastic.rehash_table(t, 8))(jt).win.data)


# ---------------------------------------------------------------------------
# tests/test_faults.py's TestStragglerBridge and TestElasticRehash, on the
# port
# ---------------------------------------------------------------------------
def _val_of(keys):
    return torch.stack([(keys * 31 + 7) & 0x7FFFFF,
                        (keys * 17 + 3) & 0x7FFFFF], dim=-1).to(torch.int32)


class TestStragglerBridge:
    def test_classify_verdicts_feed_quarantine(self):
        mon = StragglerMonitor(n_hosts=P, threshold=2.0, patience=2,
                               dead_after=3)
        base = 0.1
        for step in range(4):
            for h in range(P):
                if h == 2:
                    continue  # host 2 stops heartbeating -> dead
                mon.heartbeat(h, step, base * (8.0 if h == 1 else 1.0))
        classes = mon.classify()
        assert classes[2] == "dead"
        assert classes[1] in ("slow", "replace")
        auto = ad_mod.AdaptiveEngine(P, am_engine=am_mod.AMEngine(P))
        auto.quarantine_from_monitor(classes)
        assert 2 in auto.quarantined          # dead host quarantined
        assert 1 in auto.quarantined          # chronic straggler too
        assert 0 not in auto.quarantined and 3 not in auto.quarantined

    def test_ranks_per_host_expansion(self):
        auto = ad_mod.AdaptiveEngine(4, am_engine=am_mod.AMEngine(4))
        auto.quarantine_from_monitor({1: "dead"}, ranks_per_host=2)
        assert auto.quarantined == {2, 3}


class TestElasticRehash:
    def _filled(self, nkeys=48, seed=21):
        rng = np.random.default_rng(seed)
        keys_np = rng.choice(np.arange(1, 5000), size=nkeys, replace=False)
        keys = torch.as_tensor(keys_np.reshape(P, -1), dtype=torch.int32)
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        ht, ok, _ = ht_mod.insert_rdma(ht, keys, _val_of(keys))
        assert bool(ok.all())
        return ht, keys

    def _assert_all_found(self, ht, keys):
        kq = keys.reshape(ht.nranks, -1).to(torch.int32)
        ht, found, vals = ht_mod.find_rdma(ht, kq)
        assert bool(found.all())
        assert torch.equal(vals, _val_of(kq))

    def test_grow_round_trip(self):
        ht, keys = self._filled()
        big = elastic.rehash_table(ht, 8)
        assert big.nranks == 8
        self._assert_all_found(big, keys)

    def test_shrink_round_trip(self):
        ht, keys = self._filled()
        big = elastic.rehash_table(ht, 8)
        small = elastic.rehash_table(big, 4)
        self._assert_all_found(small, keys)
        # shrink back equals a direct rehash at 4: same insert order per
        # placement, so the record bits agree wherever both are live
        direct = elastic.rehash_table(ht, 4)
        assert int((small.win.data != 0).sum()) == int(
            (direct.win.data != 0).sum())

    def test_empty_table(self):
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        new = elastic.rehash_table(ht, 8)
        recs = new.win.data.reshape(8, new.nslots, new.rec_w)
        assert bool(((recs[..., 0] & 255) != 2).all())  # nothing live

    def test_duplicate_keys_preserved(self):
        """Duplicate keys sit outside insert_rdma's distinct-key domain:
        the drain + reinsert never multiplies records, and reads stay
        visibly correct."""
        keys = torch.full((P, 8), 123, dtype=torch.int32)
        ht = ht_mod.make_hashtable(P, NSLOTS, VW, device="cpu")
        ht, _, _ = ht_mod.insert_rdma(ht, keys, _val_of(keys))
        recs0 = ht.win.data.reshape(P, ht.nslots, ht.rec_w)
        n_old = int(((recs0[..., 0] & 255) == 2).sum())
        new = elastic.rehash_table(ht, 8)
        recs = new.win.data.reshape(8, new.nslots, new.rec_w)
        live = (recs[..., 0] & 255) == 2
        assert 1 <= int(live.sum()) <= n_old
        self._assert_all_found(new, torch.full((8, 1), 123,
                                               dtype=torch.int32))

    def test_kill_then_rehash_conformant_reads(self):
        """An injected dead owner does not perturb the rehash: drain +
        reinsert are one-sided phases, which owner faults never touch."""
        ht, keys = self._filled()
        plan = flt.FaultPlan(P, seed=31, dead_owners={3: None},
                             drop_rate=0.2)
        plan.reset()
        with flt.fault_scope(plan):
            new = elastic.rehash_table(ht, 8)
            self._assert_all_found(new, keys)
        clean = elastic.rehash_table(ht, 8)
        assert torch.equal(new.win.data, clean.win.data)
