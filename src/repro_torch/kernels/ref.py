"""Plain PyTorch versions of the kernels (ports of `repro.kernels.ref`):
the four owner-lane kernels amo_apply, fused_apply, hash_find and
hash_insert, the transactional owner lane txn_group_apply with its
serial whole-window oracle txn_apply, and the model kernels mha (flash
attention's function), decode_attention (with combine_decode_stats),
moe_dispatch and rg_lru_scan. Beside amo_apply, the JAX package's
duplicate-run pre-pass of the owner lane (combine_runs, reconstruct_runs)
and the oracle built on it, amo_apply_combined.

They take all owners at once (the leading P axis JAX vmaps over) and keep
the JAX oracles' semantics word for word, including what happens at an
offset outside [0, L): the plain `jnp` gather wraps a negative index once
and clamps, the scatter wraps and drops. The CPU tests hold these against
the JAX oracles; chip_smoke.py holds the CUDA kernels against these.

The serial walks loop in Python over the op positions where some owner
has a live op (an all-masked position changes nothing) and are vectorized
across owners, so they are slow references, not fast paths.
"""
from __future__ import annotations

import math

from typing import Tuple

import torch

from .. import intops

Tensor = torch.Tensor

OP_PUT, OP_GET, OP_CAS, OP_FAA, OP_FOR, OP_FAND, OP_FXOR = range(7)
OP_CAS_PUT, OP_CAS_PUT_PUB, OP_FAO_GET = 7, 8, 9
STATE_MASK, STATE_EMPTY, STATE_READY = 255, 0, 2


def _fao_any(cur: Tensor, a: Tensor, code: Tensor) -> Tensor:
    """Per-op fetch-and-op with a runtime kind (no-op for other codes)."""
    out = torch.where(code == OP_FAA, intops.add(cur, a), cur)
    out = torch.where(code == OP_FOR, cur | a, out)
    out = torch.where(code == OP_FAND, cur & a, out)
    return torch.where(code == OP_FXOR, cur ^ a, out)


def _amo_new(cur: Tensor, code: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """New word for primitive codes 0-6 (any other code leaves it)."""
    out = _fao_any(cur, a, code)
    out = torch.where(code == OP_PUT, b, out)
    return torch.where(code == OP_CAS, torch.where(cur == a, b, cur), out)


def _live(mask: Tensor):
    """Op positions where at least one owner has a live op."""
    return torch.nonzero(mask.any(0)).flatten().tolist()


def _word_rmw(out: Tensor, off: Tensor, do: Tensor, fn) -> Tensor:
    """One serialized step on every owner's shard: cur = out[off] (plain
    `jnp` gather), out[off] = fn(cur) where `do` (dropped out of range).
    Returns cur."""
    L = out.shape[1]
    rows = torch.arange(out.shape[0], device=out.device)
    r = intops.clip_index(off, L)
    cur = out[rows, r]
    j = intops.wrap_index(off, L)
    w = do & (j >= 0) & (j < L)
    out[rows, r] = torch.where(w, fn(cur), cur)
    return cur


def amo_apply(local: Tensor, ops: Tensor, mask: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Serialized AMOs. local (P, L) int32; ops (P, m, 4) int32 rows
    [off, opcode, a, b]; mask (P, m) bool. Returns (old (P, m), local').
    Op j observes the state left by ops < j, NIC arrival-order semantics."""
    out = local.clone()
    old = torch.zeros(ops.shape[:2], dtype=torch.int32, device=local.device)
    for j in _live(mask):
        off, code, a, b = ops[:, j].unbind(-1)
        ok = mask[:, j]
        cur = _word_rmw(out, off, ok, lambda c: _amo_new(c, code, a, b))
        old[:, j] = torch.where(ok, cur, 0)
    return old, out


# ---------------------------------------------------------------------------
# Duplicate-run combining, owner-lane side (repro.kernels.amo_apply
# combine_runs / reconstruct_runs, batched over owners): merge maximal
# CONSECUTIVE runs of combinable ops in each serialized list before the lane
# walks it, and reconstruct per-op old values after. Nothing is reordered,
# so the combined list makes exactly the state transitions of the original.
#
#   FAA             operands sum;     old_i = old_rep + prefix_sum
#   FOR/FAND/FXOR   operands fold;    old_i = binop(old_rep, prefix_fold)
#   GET             one probe;        old_i = old_rep
#   PUT             last writer wins; old_i = prev member's stored value
#   CAS             identical (a, b) rows only; losers see the chained
#                   outcome (rep won -> b, else old_rep)
# ---------------------------------------------------------------------------
def _fao_identity(code: Tensor) -> Tensor:
    return torch.where(code == OP_FAND, -1, 0).to(torch.int32)


def _fao_merge(code: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """x (op) y for the fetch-and-op `code` of each element; y for any
    other code."""
    out = torch.where(code == OP_FAA, intops.add(x, y), y)
    out = torch.where(code == OP_FOR, x | y, out)
    out = torch.where(code == OP_FAND, x & y, out)
    return torch.where(code == OP_FXOR, x ^ y, out)


def combine_runs(ops: Tensor, mask: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merge duplicate runs of each owner's serialized op list.

    ops (P, m, 4) int32 [off|code|a|b]; mask (P, m) bool. Returns
    (ops', mask', run_start (P, m), prefix (P, m)): mask' keeps only run
    representatives, ops' carries the folded operand (FAO) / last value
    (PUT) at each representative row, run_start[p, i] is the list index of
    op i's representative, prefix[p, i] the exclusive operand fold of its
    earlier run members."""
    m = mask.shape[1]
    off, code, a, b = ops.unbind(-1)
    same = (mask[:, 1:] & mask[:, :-1] & (off[:, 1:] == off[:, :-1])
            & (code[:, 1:] == code[:, :-1]))
    same = same & ((code[:, 1:] != OP_CAS)
                   | ((a[:, 1:] == a[:, :-1]) & (b[:, 1:] == b[:, :-1])))
    run_first = torch.cat([torch.ones_like(mask[:, :1]), ~same], 1)
    idx = torch.arange(m, dtype=torch.int32, device=mask.device)
    run_start = torch.cummax(torch.where(run_first, idx, -1), 1).values
    # inclusive fold within each run; a run has one code, and a code that
    # is not a fetch-and-op keeps its own operand
    incl = a
    for kind in (OP_FAA, OP_FOR, OP_FAND, OP_FXOR):
        incl = torch.where(code == kind,
                           intops.seg_scan(a, run_first, kind), incl)
    excl = torch.where(run_first, _fao_identity(code),
                       torch.roll(incl, 1, dims=1))
    run_last = torch.cat([run_first[:, 1:], torch.ones_like(mask[:, :1])],
                         1)
    end = torch.cummin(torch.where(run_last, idx, m - 1).flip(1),
                       1).values.flip(1).to(torch.int64)
    is_fao = (code >= OP_FAA) & (code <= OP_FXOR)
    a2 = torch.where(run_first & is_fao, torch.gather(incl, 1, end), a)
    b2 = torch.where(run_first & (code == OP_PUT), torch.gather(b, 1, end),
                     b)
    ops2 = torch.stack([off, code, a2, b2], dim=-1)
    return ops2, mask & run_first, run_start, excl


def reconstruct_runs(ops: Tensor, mask: Tensor, run_start: Tensor,
                     prefix: Tensor, old_rep: Tensor) -> Tensor:
    """Per-op old values (P, m) from the representatives' fetched values.

    old_rep (P, m) is the combined apply's reply (meaningful at
    representative rows). Returns old as the uncombined serialized apply
    would have fetched it."""
    m = mask.shape[1]
    code, a, b = ops[..., 1], ops[..., 2], ops[..., 3]
    idx = torch.arange(m, dtype=torch.int32, device=mask.device)
    first = (idx - run_start) == 0
    old_l = torch.gather(old_rep, 1, run_start.to(torch.int64))
    old = _fao_merge(code, old_l, prefix)
    old = torch.where(code == OP_PUT,
                      torch.where(first, old_l, torch.roll(b, 1, dims=1)),
                      old)
    old = torch.where(code == OP_CAS, torch.where(
        first, old_l, torch.where(old_l == a, b, old_l)), old)
    old = torch.where(code == OP_GET, old_l, old)
    return torch.where(mask, old, 0)


def amo_apply_combined(local: Tensor, ops: Tensor, mask: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Duplicate-run-combined oracle: merge maximal consecutive runs of
    combinable ops (combine_runs), apply the shortened lists with
    `amo_apply`, then reconstruct every op's fetched value from its
    representative's reply. Equal to `amo_apply` on the full lists for
    codes 0-6."""
    ops2, mask2, run_start, prefix = combine_runs(ops, mask)
    old_rep, local2 = amo_apply(local, ops2, mask2)
    return reconstruct_runs(ops, mask, run_start, prefix, old_rep), local2


def fused_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                reply_width: int) -> Tuple[Tensor, Tensor]:
    """Fused descriptor lane. ops (P, m, 6 + V) rows
    [off, opcode, a, b, aux0, aux1, vals...]. Returns
    (reply (P, m, reply_width), local'): reply[..., 0] is the old value at
    `off`, reply[..., 1:] the FAO_GET gather (zeros for other opcodes).

    Sub-phase decomposed, each sub-phase serialized in op order:
      1. all atomics (CAS_PUT[_PUB]'s CAS, FAO_GET's fetch-and-op with
         sub-kind `b`, primitive codes 0-6);
      2. the V-word puts of winning CAS_PUT[_PUB] ops at aux0, dropped
         whole when out of range;
      3. the publish flips of winning CAS_PUT_PUB ops (mem[off] ^= aux1);
      4. the FAO_GET gathers of G words from aux0 (a phase-end snapshot).
    """
    P, L = local.shape
    m = ops.shape[1]
    V = ops.shape[2] - 6
    G = reply_width - 1
    dev = local.device
    out = local.clone()
    old = torch.zeros((P, m), dtype=torch.int32, device=dev)
    win = torch.zeros((P, m), dtype=torch.bool, device=dev)
    code = ops[..., 1]
    is_csp = (code == OP_CAS_PUT) | (code == OP_CAS_PUT_PUB)
    for j in _live(mask):
        off, c, a, b = ops[:, j, :4].unbind(-1)
        ok = mask[:, j]

        def new(cur):
            csp = (c == OP_CAS_PUT) | (c == OP_CAS_PUT_PUB)
            nw = torch.where(csp, torch.where(cur == a, b, cur),
                             _amo_new(cur, c, a, b))
            return torch.where(c == OP_FAO_GET, _fao_any(cur, a, b), nw)

        cur = _word_rmw(out, off, ok, new)
        old[:, j] = torch.where(ok, cur, 0)
        win[:, j] = ok & (cur == a)

    rows = torch.arange(P, device=dev)[:, None]
    aux0 = ops[..., 4]
    if V > 0:
        do_put = win & is_csp & (aux0 >= 0) & (aux0 <= L - V)
        for j in _live(do_put):
            do = do_put[:, j, None]
            cols = (torch.where(do[:, 0], aux0[:, j], 0)[:, None]
                    + torch.arange(V, device=dev))
            out[rows, cols] = torch.where(do, ops[:, j, 6:], out[rows, cols])

    do_flip = win & (code == OP_CAS_PUT_PUB)
    for j in _live(do_flip):
        _word_rmw(out, ops[:, j, 0], do_flip[:, j],
                  lambda cur: cur ^ ops[:, j, 5])

    reply = torch.zeros((P, m, reply_width), dtype=torch.int32, device=dev)
    reply[..., 0] = old
    if G > 0:
        is_get = mask & (code == OP_FAO_GET) & (aux0 >= 0) & (aux0 <= L - G)
        idx = (torch.where(is_get, aux0, 0)[..., None]
               + torch.arange(G, device=dev))
        g = torch.gather(out, 1, idx.reshape(P, -1)).reshape(P, m, G)
        reply[..., 1:] = torch.where(is_get[..., None], g, 0)
    return reply, out


# ---------------------------------------------------------------------------
# txn_group_apply: the transactional owner lane with a group abort mask
# ---------------------------------------------------------------------------
def txn_group_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                    ngroups: int) -> Tuple[Tensor, Tensor]:
    """Apply groups of ops all-or-nothing against each owner's shard.

    local (P, L) int32; ops (P, m, 6) int32 rows [off, opcode, a, b, gid,
    chain]; mask (P, m) bool. Codes 0-6 act as in `amo_apply`; gid is
    clipped to [0, ngroups). A row with chain != 0 and opcode OP_CAS is a
    chain guard: if its compare fails, the whole group aborts, none of its
    ops take effect and its replies are zero. Returns (reply (P, m, 2)
    [old, applied], local').

    Two passes in op order, as the JAX oracle runs them:
      1. trial: run every live group; on a chain failure restore the shard
         to the snapshot taken at the first unmasked row of the group's
         current run (groups form contiguous runs in the layout
         `routing.flatten_owner_view` gives) and mark the group dead;
      2. apply: from the original shard, every row of a group that is not
         dead applies and replies [old-at-apply, 1]."""
    P, L = local.shape
    m = ops.shape[1]
    dev = local.device
    rows = torch.arange(P, device=dev)
    gid = ops[..., 4].clamp(0, ngroups - 1).to(torch.int64)
    is_chain = (ops[..., 5] != 0) & (ops[..., 1] == OP_CAS)
    live = _live(mask)
    loc, saved = local.clone(), local.clone()
    prev = torch.full((P,), -1, dtype=torch.int64, device=dev)
    gfail = torch.zeros((P, ngroups), dtype=torch.bool, device=dev)
    for j in live:
        off, code, a, b = ops[:, j, :4].unbind(-1)
        ok, g = mask[:, j], gid[:, j]
        newgrp = ok & (g != prev)
        saved[newgrp] = loc[newgrp]
        prev = torch.where(ok, g, prev)
        cur = loc[rows, intops.clip_index(off, L)]
        dead = gfail[rows, g]
        fail_now = ok & is_chain[:, j] & ~dead & (cur != a)
        gfail[rows, g] = dead | fail_now
        _word_rmw(loc, off, ok & ~dead & ~fail_now,
                  lambda c: _amo_new(c, code, a, b))
        loc[fail_now] = saved[fail_now]
    out = local.clone()
    old = torch.zeros((P, m), dtype=torch.int32, device=dev)
    applied = torch.zeros((P, m), dtype=torch.bool, device=dev)
    for j in live:
        off, code, a, b = ops[:, j, :4].unbind(-1)
        do = mask[:, j] & ~gfail[rows, gid[:, j]]
        cur = _word_rmw(out, off, do, lambda c: _amo_new(c, code, a, b))
        old[:, j] = torch.where(do, cur, 0)
        applied[:, j] = do
    return torch.stack([old, applied.to(torch.int32)], dim=-1), out


def txn_apply(data: Tensor, dst: Tensor, ops: Tensor, mask: Tensor,
              chain: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Serial whole-window transaction oracle.

    data (P, L) int32, the whole window; dst (T, m) int32 owner rank of
    each op; ops (T, m, 4) int32 rows [off, opcode, a, b]; mask (T, m)
    bool; chain (T, m) chain-guard flags. Returns (reply (T, m) old
    values, ok (T,) committed flags, data').

    Transaction t applies atomically after transactions < t: its ops run
    in order (op j sees ops < j of the same txn), and a chain-flagged
    OP_CAS whose compare fails aborts the whole txn: the window is left
    untouched and its replies are zero. Words are addressed in the
    flattened window (dst * L + off), read as a plain `jnp` gather reads
    them and written only inside it."""
    P, L = data.shape
    T, m = mask.shape
    flat = data.reshape(-1).clone()
    n = flat.numel()
    reply = torch.zeros((T, m), dtype=torch.int32, device=data.device)
    okt = torch.ones(T, dtype=torch.bool, device=data.device)
    for t in range(T):
        trial = flat.clone()
        old = torch.zeros(m, dtype=torch.int32, device=data.device)
        failed = False
        for j in range(m):
            if not bool(mask[t, j]):
                continue
            go = int(dst[t, j]) * L + int(ops[t, j, 0])
            w = go + n if go < 0 else go
            cur = trial[min(max(w, 0), n - 1)].clone()
            code, a, b = ops[t, j, 1], ops[t, j, 2], ops[t, j, 3]
            if int(chain[t, j]) != 0 and int(code) == OP_CAS and \
                    int(cur) != int(a):
                failed = True
                break
            if 0 <= w < n:
                trial[w] = _amo_new(cur, code, a, b)
            old[j] = cur
        if failed:
            okt[t] = False
        else:
            flat = trial
            reply[t] = old
    return reply, okt, flat.reshape(P, L)


def hash_find(table: Tensor, starts: Tensor, keys: Tensor, mask: Tensor, *,
              nslots: int, rec_w: int, max_probes: int = 8
              ) -> Tuple[Tensor, Tensor]:
    """Independent open-addressing lookups. table (P, L) int32 holding
    nslots records of rec_w words [flag|key|val...]; starts/keys/mask
    (P, m). Up to max_probes linear probes; flag low byte 2 = READY hits on
    a key match, 0 = EMPTY stops. Returns (found (P, m) bool,
    vals (P, m, rec_w-2) int32, zero where not found)."""
    P, L = table.shape
    vw = rec_w - 2
    dev = table.device
    found = torch.zeros(starts.shape, dtype=torch.bool, device=dev)
    stop = torch.zeros_like(found)
    vals = torch.zeros(starts.shape + (vw,), dtype=torch.int32, device=dev)
    words = torch.arange(rec_w, device=dev)
    for j in range(max_probes):
        s = (starts.to(torch.int64) + j) % nslots
        base = intops.slice_start(s * rec_w, rec_w, L)
        rec = torch.gather(table, 1, (base[..., None] + words).reshape(P, -1)
                           ).reshape(starts.shape + (rec_w,))
        state = rec[..., 0] & STATE_MASK
        hit = ~stop & (state == STATE_READY) & (rec[..., 1] == keys)
        empty = ~stop & (state == STATE_EMPTY)
        vals = torch.where(hit[..., None], rec[..., 2:], vals)
        found = found | hit
        stop = stop | hit | empty
    found = found & mask
    return found, torch.where(found[..., None], vals, 0)


def hash_insert(table: Tensor, starts: Tensor, keys: Tensor, vals: Tensor,
                mask: Tensor, *, nslots: int, rec_w: int, max_probes: int = 8
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Serialized insert-or-assign per owner: request j sees requests < j.
    vals (P, m, rec_w-2). Returns (ok (P, m) bool, probes (P, m) int32 —
    slots examined until the request decided, max_probes on a full-window
    miss, 0 for masked requests — and table')."""
    P, L = table.shape
    dev = table.device
    out = table.clone()
    rows = torch.arange(P, device=dev)
    words = torch.arange(rec_w, device=dev)
    ok_out = torch.zeros(starts.shape, dtype=torch.bool, device=dev)
    probes_out = torch.zeros(starts.shape, dtype=torch.int32, device=dev)
    for j in _live(mask):
        start, key, ok = starts[:, j].to(torch.int64), keys[:, j], mask[:, j]
        slot = torch.full((P,), -1, dtype=torch.int64, device=dev)
        kind = torch.zeros((P,), dtype=torch.int64, device=dev)  # 0 searching
        probes = torch.zeros((P,), dtype=torch.int32, device=dev)
        for p in range(max_probes):
            s = (start + p) % nslots
            b = intops.slice_start(s * rec_w, 2, L)
            state = out[rows, b] & STATE_MASK
            searching = kind == 0
            hit = (searching & (state == STATE_READY)
                   & (out[rows, b + 1] == key))
            empty = searching & (state == STATE_EMPTY)
            slot = torch.where(hit | empty, s, slot)
            kind = torch.where(hit, 1, torch.where(empty, 2, kind))
            probes = probes + searching.to(torch.int32)
        can = ok & (kind > 0)
        base = intops.slice_start(torch.where(can, slot * rec_w, 0), rec_w, L)
        cols = base[:, None] + words
        rec = torch.cat([torch.full((P, 1), STATE_READY, dtype=torch.int32,
                                    device=dev), key[:, None], vals[:, j]], 1)
        out[rows[:, None], cols] = torch.where(can[:, None], rec,
                                               out[rows[:, None], cols])
        ok_out[:, j] = can
        probes_out[:, j] = torch.where(ok, probes, 0)
    return ok_out, probes_out, out


# ---------------------------------------------------------------------------
# decode attention: single-token GQA decode with flash stats
# ---------------------------------------------------------------------------
def decode_attention(q: Tensor, k: Tensor, v: Tensor, length: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode with stats. q (B, H, d); k/v (B, Hkv, S, d) (any
    strides); length (B,) valid cache length. Returns (o (B, H, d), the
    *unnormalized* partial numerator, m (B, H), l (B, H)), all f32, so
    shards combine associatively:
        o = sum_j exp(s_j - m) v_j,  l = sum_j exp(s_j - m),  m = max_j s_j,
    with s_j = (q . k_j) * d ** -0.5. Query head h reads kv head
    h // (H / Hkv)."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, Hkv, g, d)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * d ** -0.5
    valid = (torch.arange(S, device=q.device)[None, :]
             < length.to(torch.int64)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1)
    msafe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(s - msafe[..., None]),
                    torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, H, d), m.reshape(B, H), l.reshape(B, H)


def combine_decode_stats(o: Tensor, m: Tensor, l: Tensor) -> Tensor:
    """Combine per-shard (o, m, l) partials along the leading axis ->
    (B, H, d): the RPC-style distributed decode, each KV shard returning
    its stats."""
    mg = m.amax(0)
    msafe = torch.where(torch.isfinite(mg), mg, torch.zeros_like(mg))
    fin = torch.isfinite(m)
    w = torch.exp(torch.where(fin, m - msafe[None],
                              torch.full_like(m, float("-inf"))))
    w = torch.where(fin, w, torch.zeros_like(w))
    num = (o * w[..., None]).sum(0)
    den = (l * w).sum(0)
    return num / torch.clamp(den, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# moe_dispatch: expert histogram + stable positions (batched FAA lane)
# ---------------------------------------------------------------------------
INT32_MIN = -(2 ** 31)


def moe_dispatch(expert_ids: Tensor, n_experts: int
                 ) -> Tuple[Tensor, Tensor]:
    """expert_ids (T,) int32 -> (counts (E,), position (T,)) int32 where
    position[i] = #{j < i : expert_j == expert_i} (stable rank within the
    expert): T chained FAAs on per-expert counters.

    Outside [0, E), as the `jnp` oracle's one-hot and fill-mode gather
    give it: such an id counts for no expert; an id in [-E, 0) reads the
    position column of id + E (the earlier tokens routed to that expert);
    any other id gets INT32_MIN."""
    ids = expert_ids.to(torch.int64)
    E = n_experts
    onehot = (ids[:, None] == torch.arange(E, device=ids.device)[None, :]
              ).to(torch.int32)
    counts = onehot.sum(0, dtype=torch.int32)
    excl = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    col = torch.where(ids < 0, ids + E, ids)
    inside = (col >= 0) & (col < E)
    pos = torch.gather(excl, 1, col.clamp(0, max(E - 1, 0))[:, None])[:, 0]
    return counts, torch.where(inside, pos, torch.full_like(pos, INT32_MIN))


# ---------------------------------------------------------------------------
# flash attention (fwd): causal / local-window GQA attention
# ---------------------------------------------------------------------------
def _live_keys(S: int, Skv: int, causal: bool, window: int,
               device) -> Tensor:
    """(S, Skv) bool: key j is live for query row i (queries end-aligned:
    row i sits at position i + Skv - S)."""
    qpos = torch.arange(S, device=device)[:, None] + (Skv - S)
    kpos = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def _scores(q: Tensor, k: Tensor, causal: bool, window: int):
    """f32 scores (B, H, S, Skv) = q . k * d**-0.5 of each query head with
    its kv head, -inf where the key is not live; and the live mask."""
    B, H, S, d = q.shape
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d ** -0.5
    ok = _live_keys(S, k.shape[2], causal, window, q.device)
    return logits.masked_fill(~ok, float("-inf")), ok


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
        window: int = 0) -> Tensor:
    """q (B, H, S, d); k/v (B, Hkv, Skv, d) (any strides) -> (B, H, S, d)
    in q's dtype, f32 math. Query head h reads kv head h // (H / Hkv);
    queries are aligned to the *end* of the kv sequence (query i sits at
    position i + Skv - S); window > 0 keeps the last `window` positions
    (inclusive). A row with no key left (causal, S > Skv) gives 0, as the
    flash forward's l = 0 does, where the JAX oracle's softmax gives NaN."""
    return flash_fwd_lse(q, k, v, causal=causal, window=window)[0]


def flash_fwd_lse(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int = 0) -> Tuple[Tensor, Tensor]:
    """mha's output and the log-sum-exp of each row's live scores, (B, H,
    S) f32: the statistic the backward recomputes the probabilities from
    (p = exp(s - lse)). A row with no live key has lse = +inf, so every
    probability it recomputes is 0."""
    g = q.shape[1] // k.shape[1]
    vf = v.float().repeat_interleave(g, dim=1)
    logits, ok = _scores(q, k, causal, window)
    m = logits.amax(-1, keepdim=True)
    msafe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - msafe)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp(min=1e-30), vf)
    lse = torch.where(ok.any(-1), (msafe + torch.log(l))[..., 0],
                      float("inf"))
    return out.to(q.dtype), lse


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
              do: Tensor, *, causal: bool = True, window: int = 0
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of flash attention (the math of the JAX model's
    _flash_train_bwd, lm.py:138-175): q, o, do (B, H, S, d); k, v (B, Hkv,
    Skv, d); lse (B, H, S) f32 from flash_fwd_lse. With s = q . k *
    scale and p = exp(s - lse) on live keys (0 elsewhere), delta = sum(do
    * o), dp = do . v and ds = p * (dp - delta) * scale: dq = ds k, dk =
    ds^T q and dv = p^T do, dk and dv summed over the g query heads of a
    kv head. f32 math; returns (dq, dk, dv) in the types of q, k, v."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = d ** -0.5
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    ok = _live_keys(S, Skv, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dk = dk.reshape(B, Hkv, g, Skv, d).sum(2)
    dv = dv.reshape(B, Hkv, g, Skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_tol(want: Tensor) -> dict:
    """The limit (assert_close keywords) to which the backward kernel is
    held against flash_bwd's gradient `want`. Both sum the same f32
    products in another order (the kernel over key and query tiles, the
    plain version in one product each); over unit-scale inputs a gradient
    element sums S or Skv terms, so f32 gets a relative 1e-5 of the
    gradient's RMS as well as 1e-5 of the value. In bf16 each side rounds
    its f32 result once: one output step (2**-7 of the value) plus 2**-8
    of the RMS, as mha_tol."""
    rms = float(want.float().square().mean().sqrt()) if want.numel() else 0.0
    if want.dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * max(rms, 1.0))
    return dict(rtol=2.0 ** -7, atol=2.0 ** -8 * rms)


def mha_tol(want: Tensor) -> dict:
    """The limit (torch.testing.assert_close keywords) to which the
    flash-attention kernel is held against `mha`'s output `want`. Both read
    the same inputs and sum in f32 in another order: in f32 that gives
    2e-5 at most over unit-scale inputs. In bf16 each side rounds its f32
    result once, so they may differ by one step of the output: at most
    2**-7 of the value. The term of 2**-8 of the output's RMS covers the
    f32 sums of values near zero, where one step is smaller than their
    difference."""
    if want.dtype == torch.float32:
        return dict(rtol=0.0, atol=2e-5)
    rms = float(want.float().square().mean().sqrt()) if want.numel() else 0.0
    return dict(rtol=2.0 ** -7, atol=2.0 ** -8 * rms)


# ---------------------------------------------------------------------------
# rg_lru_scan: the gated linear recurrence of the RG-LRU block
# ---------------------------------------------------------------------------
def rg_lru_scan(a: Tensor, b: Tensor, h0: Tensor | None = None) -> Tensor:
    """a, b (B, S, D) f32; h0 (B, D) (None: zeros). Returns h (B, S, D)
    with h_t = a_t * h_{t-1} + b_t, h_{-1} = h0. The product and the sum
    are two torch ops, each rounded on its own (no fused multiply-add),
    which the CUDA kernel repeats bit for bit."""
    B, S, D = a.shape
    h = torch.zeros((B, D), dtype=a.dtype, device=a.device) if h0 is None \
        else h0
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rg_lru_scan_bwd(a: Tensor, h: Tensor, h0: Tensor | None, dh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of rg_lru_scan: a, h (its output), dh (B, S, D) f32;
    h0 (B, D) or None (zeros). Walks t from S - 1 down with g_t = dh_t +
    a_{t+1} * g_{t+1} (g_{S-1} = dh_{S-1}) and returns (da, db, dh0) with
    db_t = g_t, da_t = g_t * h_{t-1} (h_{-1} = h0) and dh0 = a_0 * g_0.
    Product and sum are two torch ops, each rounded on its own, which the
    CUDA kernel repeats bit for bit."""
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    zero = torch.zeros((B, D), dtype=a.dtype, device=a.device)
    g = None
    for t in range(S - 1, -1, -1):
        g = dh[:, t] if g is None else dh[:, t] + a[:, t + 1] * g
        db[:, t] = g
        prev = h[:, t - 1] if t > 0 else (zero if h0 is None else h0)
        da[:, t] = g * prev
    return da, db, a[:, 0] * g


# ---------------------------------------------------------------------------
# The xLSTM cells: the mLSTM (chunkwise and one step) and the sLSTM scan
# ---------------------------------------------------------------------------
def mlstm_chunk(S: int, chunk: int = 128) -> int:
    """The chunk length of JAX's _mlstm_chunkwise: min(chunk, S), halved
    while it does not divide S (S = 6 gives 6, S = 200 gives 8, S = 100
    gives 100)."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                    C0: Tensor, n0: Tensor, m0: Tensor, with_qn: bool = False
                    ) -> Tuple[Tensor, ...]:
    """The chunkwise-parallel mLSTM of JAX's `_mlstm_chunkwise`
    (repro/models/lm.py), formula for formula: q, k, v (B, S, H, hd) f32
    (pre-scaled), the raw gate logits i, f (B, S, H) f32 and the state
    C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B, H) f32, in chunks of
    mlstm_chunk(S). Returns (h (B, S, H, hd), C, n, m), new tensors; with
    with_qn also each position's signed normalizer q . n (B, S, H), which
    the backward kernel reads. Differentiable, with JAX's gradient: the
    maxima split it in halves at a tie (torch.maximum, as jnp.maximum);
    the cummax routes it to the latest position holding the running max
    (torch.cummax's index; JAX's associative scan splits an exact tie of
    rel values in its own proportions)."""
    B, S, H, hd = q.shape
    c = mlstm_chunk(S)
    C, n, m = C0, n0, m0
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    one = torch.ones((), dtype=q.dtype, device=q.device)
    hs, qns = [], []
    for lo in range(0, S, c):
        qc, kc, vc = q[:, lo:lo + c], k[:, lo:lo + c], v[:, lo:lo + c]
        ic, fc = i[:, lo:lo + c], f[:, lo:lo + c]
        lf = torch.nn.functional.logsigmoid(fc)                # (B, c, H)
        F = torch.cumsum(lf, dim=1)
        rel = ic - F
        M = torch.maximum(m[:, None], torch.cummax(rel, dim=1).values)
        inter = torch.exp(m[:, None] - M)
        # JAX's where(tri, exp(rel - M), 0), masked before the exp: the
        # same values, and above the diagonal, where rel_s - M_t can pass
        # 88.7 (128 positions of a forget gate near 0.5), a zero gradient
        # instead of autodiff's 0 * exp(.) = 0 * inf = NaN
        d = torch.exp(torch.where(tri[None, :, :, None],
                                  rel[:, None] - M[:, :, None], -math.inf))
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * d
        num = (inter[..., None] * torch.einsum("bthd,bhde->bthe", qc, C)
               + torch.einsum("btsh,bshd->bthd", scores, vc))
        qn = (inter * torch.einsum("bthd,bhd->bth", qc, n)
              + torch.sum(scores, dim=2))
        den = torch.abs(qn)
        hs.append(num / torch.maximum(den, one)[..., None])
        qns.append(qn)
        M_end, F_end = M[:, -1], F[:, -1]
        w_end = torch.exp(rel - M_end[:, None])
        decay = torch.exp(m - M_end)
        C = (decay[..., None, None] * C
             + torch.einsum("bsh,bshd,bshe->bhde", w_end, kc, vc))
        n = decay[..., None] * n + torch.einsum("bsh,bshd->bhd", w_end, kc)
        m = F_end + M_end
    out = (torch.cat(hs, dim=1), C, n, m)
    return out + (torch.cat(qns, dim=1),) if with_qn else out


def mlstm_step_new(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                   C: Tensor, n: Tensor, m: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One mLSTM step, the `step` of JAX's mlstm_block, out of place: q,
    k, v (B, H, hd) f32, i, f (B, H) f32 raw gate logits, the state C (B,
    H, hd, hd), n (B, H, hd), m (B, H) f32. Returns (h (B, H, hd), C', n',
    m'), new tensors; differentiable with JAX's gradient (the maxima split
    it in halves at a tie)."""
    logf = torch.nn.functional.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(logf + m - m_new)
    C_new = fg[..., None, None] * C + ig[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = fg[..., None] * n + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new))
    h = num / torch.maximum(den, torch.ones_like(den))[..., None]
    return h, C_new, n_new, m_new


def mlstm_step(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
               C: Tensor, n: Tensor, m: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """mlstm_step_new with the state C, n, m updated in place (the decode
    state's contract, kernel B13's). Returns (h (B, H, hd), C, n, m)."""
    h, C_new, n_new, m_new = mlstm_step_new(q, k, v, i, f, C, n, m)
    C.copy_(C_new)
    n.copy_(n_new)
    m.copy_(m_new)
    return h, C, n, m


def slstm_scan(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
               c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
               keep: bool = False) -> Tuple[Tensor, ...]:
    """The sLSTM recurrence of JAX's slstm_block (its `step` scanned over
    the sequence): z, i, f (B, S, R) f32 pre-activations, o (B, S, R) f32
    output gates, rz (R, R) (cast to f32), the state c0, n0, h0, m0 (B, R)
    f32. Returns (hs (B, S, R), c, n, h, m), new tensors; with keep also
    each step's (c, n, m, tanh(z + h rz)) stacked (4, B, S, R), which the
    backward kernel reads. Differentiable with JAX's gradient: the maxima
    split it in halves at a tie (n == 1 at the first step from a zero
    state)."""
    rz = rz.float()
    c, n, hp, m = c0, n0, h0, m0
    one = torch.ones((), dtype=z.dtype, device=z.device)
    hs, kept = [], []
    for t in range(z.shape[1]):
        zz = torch.tanh(z[:, t] + hp @ rz)
        logf = torch.nn.functional.logsigmoid(f[:, t])
        m_new = torch.maximum(logf + m, i[:, t])
        ig = torch.exp(i[:, t] - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * zz
        n = fg * n + ig
        hp = o[:, t] * c / torch.maximum(n, one)
        m = m_new
        hs.append(hp)
        if keep:
            kept.append(torch.stack((c, n, m, zz)))
    out = (torch.stack(hs, dim=1), c, n, hp, m)
    return out + (torch.stack(kept, dim=2),) if keep else out


def _vjp(fn, xs, outs_grads):
    """The gradients of fn's outputs, weighted by outs_grads (None: that
    output is not used), with respect to the tensors xs, by autograd
    through fn(*xs) on detached copies."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in xs]
        outs = fn(*xs)
        pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    xs, [g for _, g in pairs],
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads))


def mlstm_chunkwise_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor,
                        f: Tensor, C0: Tensor, n0: Tensor, m0: Tensor,
                        h: Tensor, qn: Tensor, dh: Tensor, dC: Tensor,
                        dn: Tensor, dm: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of mlstm_chunkwise with respect to q, k, v, i and f:
    its inputs, its outputs h and qn (B, S, H) (with_qn; read by the
    kernel, recomputed here), and the gradients dh (B, S, H, hd) and dC,
    dn, dm of the final state. Returns (dq, dk, dv, di, df): autograd
    through the plain forward, JAX's gradient (ties: mlstm_chunkwise)."""
    return _vjp(lambda *xs: mlstm_chunkwise(*xs, C0, n0, m0),
                (q, k, v, i, f), (dh, dC, dn, dm))


def mlstm_step_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                   C: Tensor, n: Tensor, m: Tensor, dh: Tensor, dC: Tensor,
                   dn: Tensor, dm: Tensor) -> Tuple[Tensor, ...]:
    """The backward of one mLSTM step (mlstm_step_new): its inputs (the
    state C, n, m entering the step), dh (B, H, hd) and the gradients dC,
    dn, dm of the state it leaves. Returns (dq, dk, dv, di, df, dC, dn,
    dm): the last three those of the entering state."""
    return _vjp(mlstm_step_new, (q, k, v, i, f, C, n, m), (dh, dC, dn, dm))


def slstm_scan_bwd(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
                   c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
                   hs: Tensor, kept: Tensor, dhs: Tensor, dc: Tensor,
                   dn: Tensor, dh: Tensor, dm: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The backward of slstm_scan with respect to z, i, f and o: its
    inputs, its outputs hs and kept (keep=True; read by the kernel,
    recomputed here), dhs (B, S, R) and the gradients dc, dn, dh, dm (B,
    R) of the final state. Returns (dz, di, df, do); dz is also the
    pre-activation's gradient gpre, so rz's gradient is sum_t h_{t-1}^T
    dz_t (h_{-1} = h0)."""
    return _vjp(lambda *xs: slstm_scan(*xs, rz, c0, n0, h0, m0),
                (z, i, f, o), (dhs, dc, dn, dh, dm))


def xlstm_terms(name: str, h: Tensor) -> int:
    """The products a value of an xLSTM kernel's outputs sums, for
    xlstm_tol, from the kernel's name and its first output h: hd and the
    chunk c for mlstm_chunkwise (h (B, S, H, hd)), hd for mlstm_step (h
    (B, H, hd)), R for slstm_scan's recurrent product (hs (B, S, R))."""
    if name == "mlstm_chunkwise":
        return max(h.shape[-1], mlstm_chunk(h.shape[1]))
    if name in ("mlstm_step", "slstm_scan"):
        return h.shape[-1]
    raise ValueError(f"xlstm_terms: {name!r} is not an xLSTM kernel")


def xlstm_tol(want: Tensor, terms: int) -> dict:
    """The limit (assert_close keywords) to which the xLSTM kernels are
    held against these plain versions, on an f32 output `want` that sums
    `terms` products a value (xlstm_terms: hd or c in the mLSTM's
    contractions, R in the sLSTM's recurrent product). Both sides compute the same f32
    formulas and sum in another order: a relative 2**-23 sqrt(terms) per
    sum, which the gates' exponentials and the division by the
    normalizer carry through. 1e-5 of the value plus 1e-6 sqrt(terms) of
    the output's RMS (2.3e-5 of it at 512 terms) holds that with room."""
    rms = float(want.float().square().mean().sqrt()) if want.numel() else 0.0
    return dict(rtol=1e-5, atol=1e-6 * terms ** 0.5 * max(rms, 1e-30))


def xlstm_bwd_terms(name: str, args) -> int:
    """The products a value of an xLSTM backward's outputs sums, for
    xlstm_bwd_tol, from the kernel's name and its arguments: for
    mlstm_chunkwise_bwd (q (B, S, H, hd) first) c + hd S / c, c =
    mlstm_chunk(S): dk and dv at position s sum over the later positions
    of their chunk and, through dC', hd products a later chunk; hd for
    mlstm_step_bwd (q (B, H, hd)): the rows and columns of dC' it
    contracts; R for slstm_scan_bwd (z (B, S, R)): gh_{t-1} sums R
    products a step along the reverse chain."""
    q = args[0]
    if name == "mlstm_chunkwise_bwd":
        S, hd = q.shape[1], q.shape[-1]
        c = mlstm_chunk(S)
        return c + hd * (S // c)
    if name in ("mlstm_step_bwd", "slstm_scan_bwd"):
        return q.shape[-1]
    raise ValueError(f"xlstm_bwd_terms: {name!r} is not an xLSTM backward")


def xlstm_bwd_tol(want: Tensor, terms: int) -> dict:
    """The limit (assert_close keywords) to which the xLSTM backward
    kernels are held against these plain versions (autograd through the
    plain forwards), on an f32 gradient `want` whose values sum `terms`
    products (xlstm_bwd_terms). Both sides compute the same f32 formulas
    in another order: a relative 2**-23 sqrt(terms) a sum, as xlstm_tol.
    The gradients also pass through the stabilized exponentials exp(x)
    with |x| up to f32's exp range of about 88, where one rounding of the
    exponent is a relative 88 * 2**-23 = 1.05e-5 of the term: so 1e-5
    sqrt(terms) of the gradient's RMS, and 1e-4 of the value for the
    largest gradients, where the stabilizer's gradient nearly cancels
    (the gate gradients). On the lane cases the plain version in f32
    against the same in f64 takes at most 0.34 of this limit (hd 512 with
    |q . n| above 1)."""
    rms = float(want.float().square().mean().sqrt()) if want.numel() else 0.0
    return dict(rtol=1e-4, atol=1e-5 * terms ** 0.5 * max(rms, 1e-30))
