"""Parity of the port's owner-lane and handler kernels with the JAX oracles.

repro_torch.kernels.ref (the plain versions the CPU runs, and the spec of
the CUDA kernels) against repro.kernels.ref vmapped over owners: masked
rows, repeated offsets, CAS chains, every opcode, offsets outside [0, L),
aux0 out of range, a full table and wraparound at nslots. Bit-exact. The
CUDA kernels themselves are held against these on the card (the `cuda`
tests below and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import lane_cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_parity import (amo_inputs, probe_table, same,  # noqa: F401
                          torch_one_thread, tt)


def jv(fn):
    """A per-owner JAX oracle, vmapped over owners and jitted."""
    return jax.jit(jax.vmap(fn))


@pytest.mark.parametrize("P,L,m,span", [(1, 16, 12, 3), (3, 32, 40, 5),
                                        (4, 64, 64, 64)])
def test_amo_apply_matches_jax_ref(P, L, m, span):
    rng = np.random.default_rng(100 + m)
    local, ops, mask = amo_inputs(rng, P, L, m, span)
    old_j, new_j = jv(jref.amo_apply)(jnp.asarray(local), jnp.asarray(ops),
                                      jnp.asarray(mask))
    old_t, new_t = tref.amo_apply(tt(local), tt(ops), tt(mask))
    same(old_t, old_j, "old")
    same(new_t, new_j, "local'")


def test_amo_apply_cas_chain_and_masked_rows():
    """A CAS chain on one word (each op sees the last) with masked rows in
    between: masked rows reply 0 and leave the word alone."""
    L, m = 8, 10
    local = np.zeros((1, L), np.int32)
    ops = np.zeros((1, m, 4), np.int32)
    ops[0, :, 0] = 3
    ops[0, :, 1] = 2                          # CAS k -> k+1
    ops[0, :, 2] = np.arange(m)
    ops[0, :, 3] = np.arange(m) + 1
    mask = np.ones((1, m), bool)
    mask[0, [2, 5]] = False
    old_j, new_j = jv(jref.amo_apply)(jnp.asarray(local), jnp.asarray(ops),
                                      jnp.asarray(mask))
    old_t, new_t = tref.amo_apply(tt(local), tt(ops), tt(mask))
    same(old_t, old_j)
    same(new_t, new_j)
    assert int(new_t[0, 3]) == 2  # the chain stops at the first masked row
    assert int(old_t[0, 2]) == 0


@pytest.mark.parametrize("P,L,m,V,G", [(1, 32, 8, 2, 3), (3, 64, 20, 1, 0),
                                       (2, 128, 50, 3, 4), (2, 16, 24, 0, 1)])
def test_fused_apply_matches_jax_ref(P, L, m, V, G):
    """Heterogeneous descriptors (codes 0-9 and unknown codes), repeated
    offsets, out-of-range off and aux0."""
    rng = np.random.default_rng(7 * m + V)
    local = rng.integers(0, 6, (P, L)).astype(np.int32)
    ops = np.zeros((P, m, 6 + V), np.int32)
    ops[..., 0] = rng.integers(0, min(L, 8), (P, m))
    ops[..., 0] = np.where(rng.random((P, m)) < 0.1,
                           rng.choice([-1, -L - 1, L, L + 2], (P, m)),
                           ops[..., 0])
    ops[..., 1] = rng.integers(0, 12, (P, m))
    ops[..., 2] = rng.integers(0, 6, (P, m))
    ops[..., 3] = rng.integers(0, 10, (P, m))
    ops[..., 4] = rng.integers(-3, L + 3, (P, m))
    ops[..., 5] = rng.integers(-5, 5, (P, m))
    ops[..., 6:] = rng.integers(0, 100, (P, m, V))
    mask = rng.random((P, m)) > 0.25
    rep_j, new_j = jv(lambda l, o, mm: jref.fused_apply(
        l, o, mm, reply_width=1 + G))(jnp.asarray(local), jnp.asarray(ops),
                                      jnp.asarray(mask))
    rep_t, new_t = tref.fused_apply(tt(local), tt(ops), tt(mask),
                                    reply_width=1 + G)
    same(rep_t, rep_j, "reply")
    same(new_t, new_j, "local'")


@pytest.mark.parametrize("P,nslots,vw,m,fill", [(2, 16, 1, 10, 0.5),
                                                (1, 64, 3, 33, 0.7),
                                                (3, 32, 2, 17, 1.0)])
def test_hash_find_matches_jax_ref(P, nslots, vw, m, fill):
    rng = np.random.default_rng(nslots + m)
    table = probe_table(rng, P, nslots, vw, fill, key_span=12)
    starts = rng.integers(0, nslots, (P, m)).astype(np.int32)
    starts[:, :3] = nslots - 1 - np.arange(3)    # wraparound at nslots
    keys = rng.integers(0, 12, (P, m)).astype(np.int32)
    mask = rng.random((P, m)) > 0.2
    rec_w = 2 + vw
    f_j, v_j = jv(lambda t, s, k, mm: jref.hash_find(
        t, s, k, mm, nslots, rec_w, 8))(jnp.asarray(table),
                                        jnp.asarray(starts),
                                        jnp.asarray(keys), jnp.asarray(mask))
    f_t, v_t = tref.hash_find(tt(table), tt(starts), tt(keys), tt(mask),
                              nslots=nslots, rec_w=rec_w, max_probes=8)
    same(f_t, f_j, "found")
    same(v_t, v_j, "vals")


@pytest.mark.parametrize("P,nslots,vw,m,fill", [(2, 16, 1, 24, 0.3),
                                                (1, 64, 3, 40, 0.6),
                                                (3, 8, 2, 12, 1.0)])
def test_hash_insert_matches_jax_ref(P, nslots, vw, m, fill):
    """Serialized insert-or-assign: duplicate keys in one list (the later
    request sees the earlier), a full table, wraparound at nslots."""
    rng = np.random.default_rng(3 * nslots + m)
    table = probe_table(rng, P, nslots, vw, fill, key_span=10)
    starts = rng.integers(0, nslots, (P, m)).astype(np.int32)
    starts[:, :2] = nslots - 1
    keys = rng.integers(0, 10, (P, m)).astype(np.int32)
    vals = rng.integers(-50, 50, (P, m, vw)).astype(np.int32)
    mask = rng.random((P, m)) > 0.2
    rec_w = 2 + vw
    ok_j, pr_j, t_j = jv(lambda t, s, k, v, mm: jref.hash_insert(
        t, s, k, v, mm, nslots, rec_w, 8))(
            jnp.asarray(table), jnp.asarray(starts), jnp.asarray(keys),
            jnp.asarray(vals), jnp.asarray(mask))
    ok_t, pr_t, t_t = tref.hash_insert(tt(table), tt(starts), tt(keys),
                                       tt(vals), tt(mask), nslots=nslots,
                                       rec_w=rec_w, max_probes=8)
    same(ok_t, ok_j, "ok")
    same(pr_t, pr_j, "probes")
    same(t_t, t_j, "table'")


FIND_CASES = lane_cases.hash_find_cases()


@pytest.mark.parametrize("i", range(len(FIND_CASES)), ids=[
    label for label, _, _, _ in FIND_CASES])
def test_hash_find_case_matches_jax_ref(i):
    """The B3 edge cases of kernels/lane_cases.py (the inputs the card
    tests and chip_smoke.py hold the CUDA kernel to): the port's plain
    version against the JAX oracle, bit for bit."""
    _, _, args, kw = FIND_CASES[i]
    want = jv(lambda t, s, k, mm: jref.hash_find(
        t, s, k, mm, kw["nslots"], kw["rec_w"], kw["max_probes"]))(
            *map(jnp.asarray, args))
    got = tref.hash_find(*map(tt, args), **kw)
    for name, x, y in zip(("found", "vals"), got, want):
        same(x, y, name)


def test_hash_find_cases_reach_their_slots():
    """The B3 cases hold what they aim at: live slots only at index 15 of
    a group and at each row's last index, every one a hit; hits in the
    cases whose windows wrap and whose warps span rows."""
    cases = {label: (args, kw) for label, _, args, kw in FIND_CASES}
    (table, starts, keys, mask), kw = cases[
        "live only at index 15 of a group and the row's last"]
    m = mask.shape[1]
    live = np.flatnonzero(mask.any(0))
    assert set(live % lane_cases.FIND_GROUP) == {15} and m - 1 in live
    found, _ = tref.hash_find(tt(table), tt(starts), tt(keys), tt(mask),
                              **kw)
    assert bool(found.eq(torch.from_numpy(mask)).all())
    for label in ("windows wrap past slot nslots - 1", "m = 101, vw = 1",
                  "every slot live"):
        (table, starts, keys, mask), kw = cases[label]
        found, _ = tref.hash_find(tt(table), tt(starts), tt(keys), tt(mask),
                                  **kw)
        assert int(found.sum()) > 0, label
    (_, _, _, mask), _ = cases["every slot live"]
    assert mask.all() and mask.size % lane_cases.FIND_WARP != 0


INSERT_CASES = lane_cases.hash_insert_cases()


@pytest.mark.parametrize("i", range(len(INSERT_CASES)), ids=[
    label for label, _, _, _ in INSERT_CASES])
def test_hash_insert_case_matches_jax_ref(i):
    """The B4 edge cases of kernels/lane_cases.py (the inputs the card
    tests and chip_smoke.py hold the CUDA kernel to): the port's plain
    version against the JAX oracle, bit for bit."""
    _, _, args, kw = INSERT_CASES[i]
    want = jv(lambda t, s, k, v, mm: jref.hash_insert(
        t, s, k, v, mm, kw["nslots"], kw["rec_w"], kw["max_probes"]))(
            *map(jnp.asarray, args))
    got = tref.hash_insert(*map(tt, args), **kw)
    for name, x, y in zip(("ok", "probes", "table'"), got, want):
        same(x, y, name)


def _components(label):
    """insert_components of the case `label`, with its starts mod nslots."""
    _, _, (table, starts, _, _, mask), kw = next(
        c for c in INSERT_CASES if c[0] == label)
    comps = lane_cases.insert_components(starts, mask, L=table.shape[1],
                                         **kw)
    return comps, np.mod(starts.astype(np.int64), kw["nslots"]), kw


def test_hash_insert_cases_reach_their_components():
    """Each B4 case has the component structure it aims at (as
    insert_components, the host mirror of the kernel's grouping, finds
    it)."""
    comps, _, _ = _components("one start: 600 requests")
    assert max(map(len, comps)) == 600
    comps, s0, kw = _components("ring wrap: last and first components "
                                "merge")
    W, n = kw["max_probes"], kw["nslots"]
    # rows of one owner: the first eight rows wrap around slot n - 1
    merged = [c for c in comps if len(c) >= 8 and set(c) >= set(range(8))]
    assert len(merged) == 8
    for c in merged:
        assert (s0[0, c] >= n - W).any() and (s0[0, c] < W).any()
    comps, _, _ = _components("components W - 1 and W apart")
    for c in comps:
        c = set(c.tolist())
        assert ({0, 1} <= c) == (0 in c)      # W - 1 apart: one component
        assert not ({4, 5} <= c)              # W apart: two
    comps, _, _ = _components("L < nslots * rec_w (clamped)")
    assert sorted(map(len, comps)) == [200, 200, 200]
    comps, _, _ = _components("max_probes >= nslots")
    assert sorted(map(len, comps)) == [5, 30, 40]
    comps, _, _ = _components("live counts at the chunk")
    assert sum(map(len, comps)) == 4095 + 4096 + 4097 + 8193
    assert max(map(len, comps)) < lane_cases.CHUNK


def test_insert_components_small():
    """insert_components on a hand-made list: starts 14, 1, 9, 4, 15 on
    16 slots with W = 3: {14, 15, 1} wrap into one, {4} (exactly W past
    1), {9}; with a shard one word short, one component."""
    starts = np.array([[14, 1, 9, 4, 15 + 16]])
    mask = np.ones((1, 5), bool)
    comps = lane_cases.insert_components(starts, mask, nslots=16, rec_w=3,
                                         L=48, max_probes=3)
    assert sorted(c.tolist() for c in comps) == [[0, 1, 4], [2], [3]]
    comps = lane_cases.insert_components(starts, mask, nslots=16, rec_w=3,
                                         L=47, max_probes=3)
    assert [c.tolist() for c in comps] == [[0, 1, 2, 3, 4]]


def _run_lists(rng, P, m, span, codes):
    """Op lists with long runs: codes drawn in runs of 1-6, offsets from
    `span` words held for a few ops, CAS operands from a tiny set (equal
    and unequal (a, b) rows), INT32_MAX operands (wraparound), and masked
    gaps."""
    ops = np.zeros((P, m, 4), np.int32)
    for p in range(P):
        j = 0
        while j < m:
            k = int(rng.integers(1, 7))
            ops[p, j:j + k, 0] = rng.integers(0, span)
            ops[p, j:j + k, 1] = rng.choice(codes)
            j += k
    ops[..., 2] = rng.integers(-2, 3, (P, m))
    ops[..., 3] = rng.integers(-2, 3, (P, m))
    ops[..., 2] = np.where(rng.random((P, m)) < 0.1, 2 ** 31 - 1,
                           ops[..., 2])
    mask = rng.random((P, m)) > 0.15
    return ops, mask


@pytest.mark.parametrize("P,m,span,codes", [
    (2, 40, 2, range(7)), (3, 64, 4, range(7)),
    (1, 24, 1, (-1, 0, 1, 2, 3, 4, 5, 6, 7, 9))])
def test_combine_runs_matches_jax(P, m, span, codes):
    """combine_runs (ops', mask', run_start, prefix) and reconstruct_runs
    against the JAX package's (plain jnp), bit for bit, on runs of every
    code (unknown codes too), CAS rows with equal and unequal (a, b) and
    masked gaps."""
    from repro.kernels import amo_apply as jamo
    rng = np.random.default_rng(40 + m)
    ops, mask = _run_lists(rng, P, m, span, list(codes))
    got = tref.combine_runs(tt(ops), tt(mask))
    want = jax.jit(jax.vmap(jamo.combine_runs))(jnp.asarray(ops),
                                                jnp.asarray(mask))
    for name, x, y in zip(("ops'", "mask'", "run_start", "prefix"), got,
                          want):
        same(x, y, name)
    old_rep = rng.integers(-9, 9, (P, m)).astype(np.int32)
    same(tref.reconstruct_runs(tt(ops), tt(mask), got[2], got[3],
                               tt(old_rep)),
         jax.jit(jax.vmap(jamo.reconstruct_runs))(
             jnp.asarray(ops), jnp.asarray(mask), want[2], want[3],
             jnp.asarray(old_rep)), "old")


@pytest.mark.parametrize("P,L,m,span", [(2, 32, 16, 2), (3, 64, 40, 4),
                                        (1, 16, 8, 1)])
def test_amo_apply_combined_matches_jax_ref(P, L, m, span):
    """ref.amo_apply_combined against the JAX oracle, and, for codes 0-6,
    equal to the plain serialized apply, bit for bit."""
    rng = np.random.default_rng(50 + m)
    local = rng.integers(0, 100, (P, L)).astype(np.int32)
    ops, mask = _run_lists(rng, P, m, span, list(range(7)))
    old_t, new_t = tref.amo_apply_combined(tt(local), tt(ops), tt(mask))
    old_j, new_j = jv(jref.amo_apply_combined)(
        jnp.asarray(local), jnp.asarray(ops), jnp.asarray(mask))
    same(old_t, old_j, "old")
    same(new_t, new_j, "local'")
    old_s, new_s = tref.amo_apply(tt(local), tt(ops), tt(mask))
    same(old_t, old_s, "old vs serial")
    same(new_t, new_s, "local' vs serial")


def test_combine_runs_shortens_a_hot_list():
    """A one-word FAA hammer combines to ONE surviving op per owner with
    the summed operand; prefixes are the exclusive sums."""
    m = 24
    ops = np.zeros((2, m, 4), np.int32)
    ops[..., 1] = 3
    ops[..., 2] = np.arange(1, m + 1)
    mask = np.ones((2, m), bool)
    ops2, mask2, run_start, prefix = tref.combine_runs(tt(ops), tt(mask))
    assert mask2.sum(1).tolist() == [1, 1]
    assert ops2[:, 0, 2].tolist() == [m * (m + 1) // 2] * 2
    same(run_start, np.zeros((2, m)))
    same(prefix, np.tile(np.arange(m) * (np.arange(m) + 1) // 2, (2, 1)))


def test_cpu_tensors_take_the_plain_versions():
    """kernels.ops on CPU tensors: the plain versions, no launch counted."""
    from repro_torch.kernels import amo_apply as kamo
    from repro_torch.kernels import hash_probe as khp
    rng = np.random.default_rng(5)
    local, ops, mask = amo_inputs(rng, 2, 16, 12, 4)
    before = (kamo.amo_apply.launches, kamo.fused_apply.launches,
              khp.hash_find.launches, khp.hash_insert.launches)
    old, new = tops.amo_apply(tt(local), tt(ops), tt(mask))
    ref_old, ref_new = tref.amo_apply(tt(local), tt(ops), tt(mask))
    same(old, ref_old)
    same(new, ref_new)
    after = (kamo.amo_apply.launches, kamo.fused_apply.launches,
             khp.hash_find.launches, khp.hash_insert.launches)
    assert before == after


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: never a quiet CPU run."""
    from repro_torch.kernels import amo_apply as kamo
    local = torch.zeros((1, 4), dtype=torch.int32)
    ops = torch.zeros((1, 2, 4), dtype=torch.int32)
    mask = torch.ones((1, 2), dtype=torch.bool)
    with pytest.raises(ValueError):
        kamo.amo_apply(local, ops, mask)
