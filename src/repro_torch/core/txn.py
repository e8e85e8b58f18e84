"""Transactional multi-op windows (port of `repro.core.txn`, DESIGN.md §11).

A `Txn` stages a batch of word ops (put / get / cas / fao) across one or
more symmetric windows ("spaces": e.g. the hash table's window and the
hosted queue's), ONE transaction per rank per round, SPMD style: every
rank stages the same op list with (P,)-shaped parameters and a per-op
participation mask. `TxnEngine.run` executes the batch atomically per rank
under optimistic concurrency control with per-word write locks:

  READ      fetch every op word one-sided (or via the "txn_read" AM) and
            stamp it with the engine's per-word version counter; a retry
            round re-reads only the words whose version moved, the rest
            are served from the cached read (`TxnResult.saved_reads`).
  LOCK      CAS(0 -> rank+1) on every WRITE word of a per-space lock
            window; pure reads issue a CAS(0 -> 0) probe through the same
            serialized phase. Owners serialize in (src rank, slot) order,
            so the lowest staging rank wins every word it touches.
  VALIDATE  on the host: a rank passes iff every lock/probe reply is 0 or
            its own tag and every row was delivered.
  CHAIN     origin-side evaluation of the txn's chain guards (chain=True
            CAS ops) against the validated reads. A failed chain is a
            final logical abort: nothing applied, no retry.
  COMMIT    one `window.rdma_txn_commit` (or "txn_commit" AM) per space:
            rows [off|code|a|b|gid|chain] with gid = source rank; the owner
            lane (`kernels.ops.txn_group_apply`: kernel B9 on the card)
            applies each rank's group all-or-nothing. Replies carry
            [old-at-apply | applied]; commit rows are never coalesced.
  UNLOCK    CAS(rank+1 -> 0) on every write row.

Aborted ranks retry with capped backoff. The committed serial order is
(round asc, rank asc), so replaying `TxnResult.order` through the serial
oracle (`serial_apply`) reproduces the engine's replies and final windows
bit for bit; `find_serial_order` searches for any serial order that
explains an observed history.

The round loop is host Python in both packages: each phase's replies are
read to the host (three or four reads a round per space), and under a
fault plane every round draws its faults (the loop is not a
`faults.loop_scope`). AM phases see dead owners as undelivered rows, which
fail validation and retry until `RetryPolicy.deadline` rounds accumulate
against a rank, then `RemoteTimeout`.

Arms: "rdma" (one-sided phases), "rdma_fused" (READ phase coalesced),
"am" / "am_pt" (four AM dispatches, priced differently), "auto" (cheapest
by `costmodel.predict_arm(DSOp.TXN, ...)` under the measured abort EWMA).
Windows live on any device: lock windows are made on the data window's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import costmodel as cm
from . import faults as flt
from . import window as win_mod
from .faults import RemoteTimeout, RetryPolicy
from .types import AmoKind, OpStats, Promise, to_device, to_host
from .window import Window

# Staged op codes: the amo_apply / txn_group_apply table (AmoKind 0-6).
OP_PUT = int(AmoKind.PUT)
OP_GET = int(AmoKind.GET)
OP_CAS = int(AmoKind.CAS)
OP_FAA = int(AmoKind.FAA)
OP_FOR = int(AmoKind.FOR)
OP_FAND = int(AmoKind.FAND)
OP_FXOR = int(AmoKind.FXOR)

TXN_ARMS = ("rdma", "rdma_fused", "am", "am_pt")


def _wrap32(x: int) -> int:
    """Two's-complement int32 wraparound for the host-side simulators."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _new_val(cur: int, code: int, a: int, b: int) -> int:
    """Host mirror of the lanes' new word (codes 0-6)."""
    if code == OP_PUT:
        return _wrap32(b)
    if code == OP_GET:
        return cur
    if code == OP_CAS:
        return _wrap32(b) if cur == a else cur
    if code == OP_FAA:
        return _wrap32(cur + a)
    if code == OP_FOR:
        return _wrap32(cur | a)
    if code == OP_FAND:
        return _wrap32(cur & a)
    if code == OP_FXOR:
        return _wrap32(cur ^ a)
    raise ValueError(f"unknown txn opcode {code}")


@dataclass
class TxnOp:
    """One staged word op: (P,)-shaped params, one row per rank."""

    space: str
    code: int
    dst: np.ndarray     # (P,) int32 owner rank
    off: np.ndarray     # (P,) int32 word offset
    a: np.ndarray       # (P,) int32 compare value / operand
    b: np.ndarray       # (P,) int32 swap / store value
    chain: bool         # chain guard: CAS failure aborts the whole txn
    valid: np.ndarray   # (P,) bool rank participation


class Txn:
    """Staging container: one transaction per rank, SPMD parameters.

    Every method takes (P,)-broadcastable int params and an optional
    per-rank `valid` mask, appends one `TxnOp`, and returns its op index
    (the column of `TxnResult.replies` holding that op's fetched value).
    """

    def __init__(self, nranks: int):
        self.nranks = int(nranks)
        self.ops: List[TxnOp] = []

    def _stage(self, space: str, code: int, dst, off, a=0, b=0,
               chain: bool = False, valid=None) -> int:
        P = self.nranks

        def col(x):
            return np.ascontiguousarray(
                np.broadcast_to(np.asarray(x, np.int32), (P,)))
        v = (np.ones(P, dtype=bool) if valid is None
             else np.ascontiguousarray(
                 np.broadcast_to(np.asarray(valid, bool), (P,))))
        if chain and code != OP_CAS:
            raise ValueError("chain guards are CAS ops (cmp -> swap)")
        self.ops.append(TxnOp(space=space, code=int(code), dst=col(dst),
                              off=col(off), a=col(a), b=col(b),
                              chain=bool(chain), valid=v))
        return len(self.ops) - 1

    def put(self, dst, off, val, *, space: str = "ht", valid=None) -> int:
        return self._stage(space, OP_PUT, dst, off, 0, val, valid=valid)

    def get(self, dst, off, *, space: str = "ht", valid=None) -> int:
        return self._stage(space, OP_GET, dst, off, valid=valid)

    def cas(self, dst, off, cmp, new, *, space: str = "ht",
            chain: bool = False, valid=None) -> int:
        return self._stage(space, OP_CAS, dst, off, cmp, new, chain=chain,
                           valid=valid)

    def fao(self, dst, off, operand, kind: AmoKind = AmoKind.FAA, *,
            space: str = "ht", valid=None) -> int:
        code = int(kind)
        if not OP_FAA <= code <= OP_FXOR:
            raise ValueError(f"fao kind must be FAA/FOR/FAND/FXOR, got {kind}")
        return self._stage(space, code, dst, off, operand, valid=valid)

    @property
    def spaces(self) -> List[str]:
        """Staged spaces, in first-touch order."""
        seen: List[str] = []
        for op in self.ops:
            if op.space not in seen:
                seen.append(op.space)
        return seen

    def has_ops(self) -> np.ndarray:
        """(P,) bool: ranks that staged at least one valid op."""
        if not self.ops:
            return np.zeros(self.nranks, dtype=bool)
        return np.logical_or.reduce([op.valid for op in self.ops])


@dataclass
class _SpaceBatch:
    """Per-space columnar view of a Txn: arrays are (P, m_s)."""

    idx: List[int]        # global op indices, staging order
    dst: np.ndarray
    off: np.ndarray
    a: np.ndarray
    b: np.ndarray
    code: np.ndarray      # (m_s,)
    chain: np.ndarray     # (m_s,) bool
    write: np.ndarray     # (m_s,) bool: everything but GET takes the lock
    opvalid: np.ndarray   # (P, m_s)


def _batches(txn: Txn) -> Dict[str, _SpaceBatch]:
    out: Dict[str, _SpaceBatch] = {}
    for s in txn.spaces:
        idx = [j for j, op in enumerate(txn.ops) if op.space == s]
        ops = [txn.ops[j] for j in idx]
        out[s] = _SpaceBatch(
            idx=idx,
            dst=np.stack([o.dst for o in ops], axis=1),
            off=np.stack([o.off for o in ops], axis=1),
            a=np.stack([o.a for o in ops], axis=1),
            b=np.stack([o.b for o in ops], axis=1),
            code=np.array([o.code for o in ops], np.int32),
            chain=np.array([o.chain for o in ops], bool),
            write=np.array([o.code != OP_GET for o in ops], bool),
            opvalid=np.stack([o.valid for o in ops], axis=1))
    return out


@dataclass
class ReadSet:
    """Prefetched (value, version-stamp) reads, the depth-2 hook: built by
    `TxnEngine.prefetch_reads` for the next txn batch; the round loop
    trusts a prefetched word only while its stamp still matches."""

    vals: Dict[str, np.ndarray]    # space -> (P, m_s) int32
    stamp: Dict[str, np.ndarray]   # space -> (P, m_s) int64
    have: Dict[str, np.ndarray]    # space -> (P, m_s) bool


@dataclass
class TxnResult:
    """Outcome of one `TxnEngine.run` round loop."""

    committed: np.ndarray          # (P,) bool
    chain_ok: np.ndarray           # (P,) bool: False = final logical abort
    replies: np.ndarray            # (P, M) int32 old-at-apply per op
    wins: Dict[str, Window]        # updated windows per space
    order: List[Tuple[int, int]]   # committed (round, rank), serial order
    rounds: int
    attempts: np.ndarray           # (P,) round attempts per rank
    commits: int
    aborts: int                    # validation aborts (all retried)
    chain_aborts: int              # final logical aborts
    abort_rate: float              # aborts / total round attempts
    saved_reads: int               # stamp-validated cached reads reused
    arm: str

    def window(self, space: Optional[str] = None) -> Window:
        if space is None:
            (space,) = self.wins.keys()
        return self.wins[space]


def _cas_handler(local, payload, mask):
    """The "txn_cas" AM body: a serialized CAS batch at every owner (the
    B1 kernel on the card, the appliers on the CPU)."""
    off, cmp, new = payload[..., 0], payload[..., 1], payload[..., 2]
    if local.is_cuda:
        from ..kernels import ops as kops
        ops = torch.stack([off, torch.full_like(off, OP_CAS), cmp, new],
                          dim=-1)
        old, local2 = kops.amo_apply(local, ops, mask)
    else:
        old, local2 = win_mod.apply_cas_local(local, off, cmp, new, mask)
    return local2, old[..., None]


def _read_handler(local, payload, mask):
    """The "txn_read" AM body: one word from every owner's shard."""
    vals = win_mod.gather_local(local, payload[..., 0], 1)
    return local, torch.where(mask[..., None], vals, 0)


class TxnEngine:
    """Batched multi-op transaction executor over symmetric windows.

    One engine per set of co-transacted structures: it owns the per-space
    lock windows and version counters, registers the txn AM handlers on a
    shared `AMEngine` when an AM arm first runs, and feeds the measured
    abort rate to an attached `AdaptiveEngine`. `cache`: a
    core/cache.BucketCache of the table in `cache_space`, told of every
    committed write."""

    def __init__(self, nranks: int, am_engine=None,
                 retry: RetryPolicy = RetryPolicy(), cache=None,
                 cache_space: str = "ht", adaptive=None,
                 backoff_cap: int = 4):
        self.nranks = int(nranks)
        self.am_engine = am_engine
        self.retry = retry
        self.cache = cache
        self.cache_space = cache_space
        self.adaptive = adaptive
        self.backoff_cap = int(backoff_cap)
        self._locks: Dict[str, Window] = {}
        # per-space per-word commit counters: version stamps for the
        # optimistic read cache
        self.versions: Dict[str, np.ndarray] = {}

    # -- space state --------------------------------------------------------
    def _ensure_space(self, space: str, win: Window) -> None:
        shape = tuple(win.data.shape)
        lock = self._locks.get(space)
        if (lock is None or tuple(lock.data.shape) != shape
                or lock.data.device != win.data.device):
            self._locks[space] = win_mod.make_window(
                shape[0], shape[1], device=win.data.device)
            self.versions[space] = np.zeros(shape, dtype=np.int64)

    # -- AM handlers --------------------------------------------------------
    def _ensure_handlers(self):
        eng = self.am_engine
        if eng is None:
            raise ValueError("AM txn arms need an AMEngine")
        if not eng.has_handler("txn_read"):
            eng.register("txn_read", _read_handler, reply_width=1)
        if not eng.has_handler("txn_cas"):
            eng.register("txn_cas", _cas_handler, reply_width=1)
        if not eng.has_handler("txn_commit"):
            from ..kernels import ops as kops
            from ..kernels import ref as kref
            ngroups = self.nranks

            def commit_fn(local, payload, mask):
                reply, local2 = kref.txn_group_apply(local, payload, mask,
                                                     ngroups=ngroups)
                return local2, reply

            def commit_batched(data, flat, mask):
                reply, data2 = kops.txn_group_apply(data, flat, mask,
                                                    ngroups=ngroups)
                return data2, reply

            eng.register("txn_commit", commit_fn, reply_width=2,
                         batched_fn=commit_batched)
        return eng

    # -- phase helpers (numpy in, numpy out) --------------------------------
    @staticmethod
    def _dev(win: Window, B: _SpaceBatch, valid: np.ndarray):
        dev = win.data.device
        return (to_device(B.dst, torch.int32, dev),
                to_device(valid, torch.bool, dev), dev)

    def _read_phase(self, win: Window, B: _SpaceBatch, valid: np.ndarray,
                    arm: str) -> Tuple[np.ndarray, np.ndarray, Window]:
        dst, vj, dev = self._dev(win, B, valid)
        off = to_device(B.off, torch.int32, dev)
        if arm in ("am", "am_pt"):
            eng = self.am_engine
            data, rep, dlv = eng.dispatch(eng.handler("txn_read"), win.data,
                                          dst, off[..., None], vj)
            return to_host(rep[..., 0]), to_host(dlv), Window(data=data)
        out = win_mod.rdma_get(win, dst, off, 1, valid=vj,
                               coalesce=(arm == "rdma_fused"))
        return to_host(out[..., 0]), np.ones_like(valid), win

    def _cas_phase(self, lock: Window, B: _SpaceBatch, cmp: np.ndarray,
                   new: np.ndarray, valid: np.ndarray, arm: str
                   ) -> Tuple[np.ndarray, np.ndarray, Window]:
        dst, vj, dev = self._dev(lock, B, valid)
        off, cmp_t, new_t = (to_device(x, torch.int32, dev)
                             for x in (B.off, cmp, new))
        if arm in ("am", "am_pt"):
            eng = self.am_engine
            payload = torch.stack([off, cmp_t, new_t], dim=-1)
            data, rep, dlv = eng.dispatch(eng.handler("txn_cas"), lock.data,
                                          dst, payload, vj)
            return to_host(rep[..., 0]), to_host(dlv), Window(data=data)
        # never coalesced: lock tags differ per rank, and merging identical
        # cross-rank probe rows would be unsound
        old, lock2 = win_mod.rdma_cas(lock, dst, off, cmp_t, new_t,
                                      valid=vj)
        return to_host(old), np.ones_like(valid), lock2

    def _commit_phase(self, win: Window, B: _SpaceBatch, valid: np.ndarray,
                      arm: str) -> Tuple[np.ndarray, np.ndarray, Window]:
        P = self.nranks
        gid = np.broadcast_to(np.arange(P, dtype=np.int32)[:, None],
                              B.dst.shape)
        chain = np.broadcast_to(B.chain.astype(np.int32)[None, :],
                                B.dst.shape)
        code = np.broadcast_to(B.code[None, :], B.dst.shape)
        desc = np.stack([B.off, code, B.a, B.b, gid, chain],
                        axis=-1).astype(np.int32)
        dst, vj, dev = self._dev(win, B, valid)
        desc_t = to_device(desc, torch.int32, dev)
        if arm in ("am", "am_pt"):
            eng = self.am_engine
            data, rep, dlv = eng.dispatch(eng.handler("txn_commit"),
                                          win.data, dst, desc_t, vj)
            return to_host(rep), to_host(dlv), Window(data=data)
        rep, win2 = win_mod.rdma_txn_commit(win, dst, desc_t, valid=vj)
        return to_host(rep), np.ones_like(valid), win2

    # -- origin-side chain evaluation ---------------------------------------
    def _simulate(self, txn: Txn, batches: Dict[str, _SpaceBatch],
                  reads: ReadSet, ranks: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Serially evaluate each selected rank's txn against its
        validated READ snapshot. Returns (sim_replies (P, M), chain_fail
        (P,)). Sound because every word a chain guard compares is
        write-locked by this rank for the rest of the round, and every
        probe-validated read word is only written by higher ranks this
        round, whose commit rows serialize after ours at the owner."""
        P, M = self.nranks, len(txn.ops)
        pos = {}
        for s, B in batches.items():
            for jj, j in enumerate(B.idx):
                pos[j] = (s, jj)
        sim = np.zeros((P, M), dtype=np.int32)
        fail = np.zeros(P, dtype=bool)
        for p in np.nonzero(ranks)[0]:
            env: Dict[Tuple[str, int, int], int] = {}
            for j, op in enumerate(txn.ops):
                if not op.valid[p]:
                    continue
                s, jj = pos[j]
                key = (s, int(op.dst[p]), int(op.off[p]))
                cur = env.get(key)
                if cur is None:
                    cur = int(reads.vals[s][p, jj])
                a, b = int(op.a[p]), int(op.b[p])
                if op.chain and op.code == OP_CAS and cur != a:
                    fail[p] = True
                    break
                sim[p, j] = np.int32(cur)
                env[key] = _new_val(cur, op.code, a, b)
            if fail[p]:
                sim[p, :] = 0
        return sim, fail

    # -- arm choice ---------------------------------------------------------
    def _choose_arm(self, txn: Txn) -> str:
        arms = ["rdma", "rdma_fused"]
        if self.am_engine is not None:
            arms += ["am", "am_pt"]
        m = max(1, len(txn.ops))
        ab = self.adaptive.abort_ewma if self.adaptive is not None else 0.0
        s = OpStats(ops_per_rank=m, nranks=self.nranks,
                    abort_rate=min(0.95, ab))
        params = (self.adaptive.params if self.adaptive is not None
                  else cm.CORI_PHASE1)
        scores = {a: cm.predict_arm(cm.DSOp.TXN, Promise.CRW, a, s, params)
                  for a in arms}
        return min(scores, key=lambda a: (scores[a], a))

    # -- pipelined submission (depth 2) -------------------------------------
    def prefetch_reads(self, wins, txn: Txn, arm: str = "rdma_fused"
                       ) -> ReadSet:
        """Issue the READ phase for `txn` now, against the current windows.
        The returned ReadSet carries version stamps; `run(prefetch=...)`
        re-reads only words a commit moved."""
        wins = self._norm_wins(wins, txn)
        if arm == "auto":
            arm = self._choose_arm(txn)
        if arm in ("am", "am_pt"):
            self._ensure_handlers()
        batches = _batches(txn)
        rs = ReadSet(vals={}, stamp={}, have={})
        for s, B in batches.items():
            self._ensure_space(s, wins[s])
            vals, dlv, _ = self._read_phase(wins[s], B, B.opvalid, arm)
            got = B.opvalid & dlv
            rs.vals[s] = np.where(got, vals, 0).astype(np.int32)
            rs.stamp[s] = self.versions[s][B.dst, B.off].copy()
            rs.have[s] = got
        return rs

    def run_many(self, wins, txns: Sequence[Txn], arm: str = "rdma_fused",
                 depth: int = 1) -> Tuple[List[TxnResult], Dict[str, Window]]:
        """Run a sequence of txn batches. depth >= 2 prefetches batch k+1's
        READ phase before batch k runs; the stamp protocol keeps results
        bit for bit equal to depth 1."""
        wins = dict(wins) if not isinstance(wins, Window) else wins
        results: List[TxnResult] = []
        pre: Optional[ReadSet] = None
        for i, txn in enumerate(txns):
            w = self._norm_wins(wins, txn)
            if depth >= 2 and pre is None:
                pre = self.prefetch_reads(w, txn, arm)
            nxt = None
            if depth >= 2 and i + 1 < len(txns):
                nxt = self.prefetch_reads(self._norm_wins(wins, txns[i + 1]),
                                          txns[i + 1], arm)
            res = self.run(w, txn, arm=arm, prefetch=pre)
            if isinstance(wins, Window):
                wins = res.wins[txn.spaces[0]]
            else:
                wins.update(res.wins)
            results.append(res)
            pre = nxt
        final = (self._norm_wins(wins, txns[-1]) if txns else
                 (wins if isinstance(wins, dict) else {}))
        return results, (final if isinstance(final, dict) else dict(final))

    def _norm_wins(self, wins, txn: Txn) -> Dict[str, Window]:
        if isinstance(wins, Window):
            spaces = txn.spaces
            if not spaces:
                return {}  # empty txn: nothing to execute
            if len(spaces) != 1:
                raise ValueError("multi-space txn needs a {space: Window} "
                                 "dict")
            return {spaces[0]: wins}
        return dict(wins)

    # -- the round loop -----------------------------------------------------
    def run(self, wins, txn: Txn, arm: str = "rdma_fused",
            max_rounds: Optional[int] = None,
            prefetch: Optional[ReadSet] = None) -> TxnResult:
        """Execute one txn batch (one transaction per rank) to completion.

        `wins` is a single `Window` (single-space txn) or a {space: Window}
        dict and is never mutated; the updated windows are in
        `TxnResult.wins`."""
        wins = self._norm_wins(wins, txn)
        P, M = self.nranks, len(txn.ops)
        if arm == "auto":
            arm = self._choose_arm(txn)
        if arm not in TXN_ARMS:
            raise ValueError(f"unknown txn arm {arm!r}")
        if arm in ("am", "am_pt"):
            self._ensure_handlers()
        batches = _batches(txn)
        for s in txn.spaces:
            self._ensure_space(s, wins[s])
        plane = flt.active_plane()
        pol = plane.retry if plane is not None else self.retry
        if max_rounds is None:
            max_rounds = 16 * P + 4 * self.backoff_cap + pol.deadline + 16
        tags = np.arange(P, dtype=np.int32) + 1

        has = txn.has_ops()
        active = has.copy()
        committed = ~has.copy()  # op-less ranks commit the empty txn
        chain_ok = np.ones(P, dtype=bool)
        attempts = np.zeros(P, dtype=np.int64)
        skip = np.zeros(P, dtype=np.int64)
        undeliv = np.zeros(P, dtype=np.int64)
        replies = np.zeros((P, M), dtype=np.int32)
        order: List[Tuple[int, int]] = []
        aborts = saved_reads = rounds = 0

        reads = prefetch if prefetch is not None else ReadSet(
            vals={}, stamp={}, have={})
        for s, B in batches.items():
            if s not in reads.vals:
                reads.vals[s] = np.zeros(B.dst.shape, np.int32)
                reads.stamp[s] = np.zeros(B.dst.shape, np.int64)
                reads.have[s] = np.zeros(B.dst.shape, bool)

        while active.any():
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(f"txn round loop did not converge in "
                                   f"{max_rounds} rounds (arm={arm})")
            run_mask = active & (skip == 0)
            skip = np.maximum(skip - 1, 0)
            if not run_mask.any():
                continue
            attempts[run_mask] += 1
            exh0 = plane.exhausted if plane is not None else 0
            dlv_ok = np.ones(P, dtype=bool)

            # READ: stamp-validated, served from the read cache where the
            # versions held
            for s, B in batches.items():
                cur_ver = self.versions[s][B.dst, B.off]
                want = B.opvalid & run_mask[:, None]
                need = want & (~reads.have[s] | (reads.stamp[s] != cur_ver))
                saved_reads += int((want & ~need).sum())
                if need.any():
                    vals, dlv, wins[s] = self._read_phase(wins[s], B, need,
                                                          arm)
                    got = need & dlv
                    reads.vals[s] = np.where(got, vals, reads.vals[s])
                    reads.stamp[s] = np.where(got, cur_ver, reads.stamp[s])
                    reads.have[s] = reads.have[s] | got
                    dlv_ok &= ~(need & ~dlv).any(axis=1)

            # LOCK + probe: one serialized CAS phase per space
            lock_old: Dict[str, np.ndarray] = {}
            lock_dlv: Dict[str, np.ndarray] = {}
            for s, B in batches.items():
                lvalid = B.opvalid & run_mask[:, None]
                new = np.where(B.write[None, :], tags[:, None],
                               0).astype(np.int32)
                old, dlv, self._locks[s] = self._cas_phase(
                    self._locks[s], B, np.zeros_like(new), new, lvalid, arm)
                lock_old[s], lock_dlv[s] = old, dlv
                dlv_ok &= ~(lvalid & ~dlv).any(axis=1)

            # VALIDATE: all replies delivered and unowned-or-ours
            validated = run_mask & dlv_ok
            for s, B in batches.items():
                lvalid = B.opvalid & run_mask[:, None]
                okrow = (~lvalid) | (lock_dlv[s]
                                     & ((lock_old[s] == 0)
                                        | (lock_old[s] == tags[:, None])))
                validated &= okrow.all(axis=1)
            if plane is not None and plane.exhausted > exh0:
                # wire exhaustion inside read/lock: a lost CAS reply is
                # indistinguishable from a won lock; abort the round
                validated[:] = False

            # CHAIN: origin-side evaluation on the validated snapshot
            sim, chain_fail = self._simulate(txn, batches, reads, validated)
            chain_abort = validated & chain_fail
            commit_mask = validated & ~chain_fail

            # COMMIT: grouped all-or-nothing apply, never coalesced
            exh1 = plane.exhausted if plane is not None else 0
            if commit_mask.any():
                for s, B in batches.items():
                    cvalid = B.opvalid & commit_mask[:, None]
                    if not cvalid.any():
                        continue
                    rep, dlv, wins[s] = self._commit_phase(wins[s], B,
                                                           cvalid, arm)
                    if (cvalid & ~dlv).any():
                        raise RuntimeError(
                            "txn commit row undelivered after lock "
                            "validation: owner died mid-round")
                    applied = rep[..., 1] != 0
                    if (cvalid & ~applied).any():
                        raise RuntimeError(
                            "owner chain lane aborted a commit the origin "
                            "validated: protocol invariant violated")
                    for jj, j in enumerate(B.idx):
                        sel = cvalid[:, jj]
                        replies[sel, j] = rep[sel, jj, 0]
                    # publish: bump version stamps for every written word
                    wsel = cvalid & B.write[None, :]
                    if wsel.any():
                        np.add.at(self.versions[s],
                                  (B.dst[wsel], B.off[wsel]), 1)
                        if self.cache is not None and s == self.cache_space:
                            self.cache.on_publish(B.dst, B.off, valid=wsel)
                # owner apply == origin simulation for every committed op
                gvalid = np.zeros((P, M), dtype=bool)
                for s, B in batches.items():
                    for jj, j in enumerate(B.idx):
                        gvalid[:, j] = B.opvalid[:, jj]
                chk = commit_mask[:, None] & gvalid
                if not np.array_equal(replies[chk], sim[chk]):
                    raise RuntimeError("commit replies diverged from the "
                                       "origin-side serial evaluation")

            # UNLOCK: release every write row we might hold
            for s, B in batches.items():
                uvalid = B.opvalid & run_mask[:, None] & B.write[None, :]
                if uvalid.any():
                    _, _, self._locks[s] = self._cas_phase(
                        self._locks[s], B, np.broadcast_to(
                            tags[:, None], B.dst.shape).astype(np.int32),
                        np.zeros(B.dst.shape, np.int32), uvalid, arm)
            if plane is not None and plane.exhausted > exh1:
                raise RuntimeError("wire exhaustion during commit/unlock: "
                                   "atomicity cannot be preserved")

            # bookkeeping + finalization
            failed = run_mask & ~validated
            aborts += int(failed.sum())
            undeliv[run_mask & ~dlv_ok] += 1
            undeliv[run_mask & dlv_ok] = 0
            committed |= commit_mask
            chain_ok &= ~chain_abort
            active &= ~(commit_mask | chain_abort)
            order.extend((rounds, int(p)) for p in np.nonzero(commit_mask)[0])
            skip[failed] = np.minimum(attempts[failed] - 1, self.backoff_cap)
            late = active & (undeliv >= pol.deadline)
            if late.any():
                raise RemoteTimeout(
                    f"txn at rank {int(np.nonzero(late)[0][0])} undelivered "
                    f"for {pol.deadline} rounds (dead owner?)")

        total = int(attempts.sum())
        commits = int((committed & has).sum())
        chain_aborts = int((~chain_ok).sum())
        abort_rate = aborts / max(1, total)
        if self.adaptive is not None:
            self.adaptive.ingest_txn_stats(total - aborts, aborts)
        return TxnResult(committed=committed, chain_ok=chain_ok,
                         replies=replies, wins=wins, order=order,
                         rounds=rounds, attempts=attempts, commits=commits,
                         aborts=aborts, chain_aborts=chain_aborts,
                         abort_rate=abort_rate, saved_reads=saved_reads,
                         arm=arm)


# ---------------------------------------------------------------------------
# Serial oracle + serializability checker (the conformance ground truth)
# ---------------------------------------------------------------------------
def _apply_txn_np(state: Dict[str, np.ndarray], txn: Txn, rank: int
                  ) -> Tuple[np.ndarray, bool, Dict[str, np.ndarray]]:
    """Apply ONE rank's staged transaction serially against host-side
    window images. Returns (replies (M,), committed, state'); on a chain
    abort the state is returned untouched and the replies zeroed, as
    `kernels.ref.txn_apply` defines the oracle."""
    M = len(txn.ops)
    rep = np.zeros(M, dtype=np.int32)
    st = {s: a.copy() for s, a in state.items()}
    for j, op in enumerate(txn.ops):
        if not op.valid[rank]:
            continue
        d, o = int(op.dst[rank]), int(op.off[rank])
        cur = int(st[op.space][d, o])
        a, b = int(op.a[rank]), int(op.b[rank])
        if op.chain and op.code == OP_CAS and cur != a:
            return np.zeros(M, dtype=np.int32), False, state
        rep[j] = np.int32(cur)
        st[op.space][d, o] = _new_val(cur, op.code, a, b)
    return rep, True, st


def serial_apply(state: Dict[str, np.ndarray], txn: Txn,
                 ranks: Sequence[int]
                 ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Replay `txn` for the given ranks in order (e.g. the ranks of
    `TxnResult.order`). Returns (replies (P, M), final state); chain
    aborts are no-ops with zeroed replies."""
    P, M = txn.nranks, len(txn.ops)
    replies = np.zeros((P, M), dtype=np.int32)
    st = {s: np.array(a, dtype=np.int32, copy=True)
          for s, a in state.items()}
    for p in ranks:
        rep, _, st = _apply_txn_np(st, txn, int(p))
        replies[int(p)] = rep
    return replies, st


def find_serial_order(initial: Dict[str, np.ndarray], txn: Txn,
                      committed: np.ndarray, replies: np.ndarray,
                      final: Dict[str, np.ndarray]
                      ) -> Optional[List[int]]:
    """Serializability checker: find any serial order of the finalized
    transactions that reproduces the observed history.

    A rank's observation is (committed flag, reply vector); a committed
    txn must replay with identical replies, an aborted one must abort (its
    chain guard must fail) at its position. The leaf compares the
    replayed windows with `final`. Returns the witness order (list of
    ranks), or None for a history no serial order explains."""
    has = txn.has_ops()
    committed = np.asarray(committed, bool)
    todo = [int(p) for p in range(txn.nranks) if has[p]]
    init = {s: np.array(a, dtype=np.int32, copy=True)
            for s, a in initial.items()}

    def match_final(st: Dict[str, np.ndarray]) -> bool:
        return all(np.array_equal(st[s], final[s]) for s in st)

    def search(st: Dict[str, np.ndarray], remaining: List[int],
               acc: List[int]) -> Optional[List[int]]:
        if not remaining:
            return list(acc) if match_final(st) else None
        for p in remaining:
            rep, ok, st2 = _apply_txn_np(st, txn, p)
            if ok != bool(committed[p]):
                continue
            if ok and not np.array_equal(rep, replies[p]):
                continue
            rest = [q for q in remaining if q != p]
            acc.append(p)
            hit = search(st2, rest, acc)
            if hit is not None:
                return hit
            acc.pop()
        return None

    return search(init, todo, [])
