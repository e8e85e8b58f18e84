"""Device dispatch for the kernels: the owner lanes (the transactional one
included) and handler bodies of the data structures, and attention,
decode attention, expert dispatch, the RG-LRU scan and the xLSTM cells
(the chunkwise mLSTM, its step and the sLSTM scan) of the model, and the
backwards of attention, of the RG-LRU scan and of the xLSTM cells.

A CUDA tensor launches the hand-written kernel (inputs are made
contiguous first, except the attention kernels' q, k, v, o and do and
flash_decode's K and V, which the kernels read through their strides); a
CPU tensor takes
the plain PyTorch version in kernels/ref.py. There is no fallback: a
kernel that fails to build or to launch raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import amo_apply as _amo
from . import flash_attention as _fa
from . import flash_attention_bwd as _fab
from . import flash_decode as _fd
from . import hash_probe as _hp
from . import moe_dispatch as _md
from . import rg_lru as _rg
from . import ref
from . import txn_lane as _tx
from . import xlstm as _xl

Tensor = torch.Tensor


def amo_apply(local: Tensor, ops: Tensor, mask: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """Serialized AMO batch per owner. local (P, L); ops (P, m, 4) rows
    [off|opcode|a|b]; mask (P, m). Returns (old (P, m), local')."""
    if local.is_cuda:
        return _amo.amo_apply(local.contiguous(), ops.contiguous(),
                              mask.contiguous())
    return ref.amo_apply(local, ops, mask)


def fused_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                reply_width: int) -> Tuple[Tensor, Tensor]:
    """Fused descriptor batch per owner. ops (P, m, 6 + V). Returns
    (reply (P, m, reply_width), local')."""
    if local.is_cuda:
        return _amo.fused_apply(local.contiguous(), ops.contiguous(),
                                mask.contiguous(), reply_width=reply_width)
    return ref.fused_apply(local, ops, mask, reply_width=reply_width)


def txn_group_apply(local: Tensor, ops: Tensor, mask: Tensor, *,
                    ngroups: int) -> Tuple[Tensor, Tensor]:
    """Transactional owner lane with the group abort mask. local (P, L);
    ops (P, m, 6) rows [off|code|a|b|gid|chain]; mask (P, m). Returns
    (reply (P, m, 2) [old, applied], local')."""
    if local.is_cuda:
        return _tx.txn_group_apply(local.contiguous(), ops.contiguous(),
                                   mask.contiguous(), ngroups=ngroups)
    return ref.txn_group_apply(local, ops, mask, ngroups=ngroups)


def hash_find(table, starts, keys, mask, *, nslots, rec_w, max_probes=8):
    """Batched lookups. Returns (found (P, m) bool, vals (P, m, rec_w-2))."""
    if table.is_cuda:
        return _hp.hash_find(table.contiguous(), starts.contiguous(),
                             keys.contiguous(), mask.contiguous(),
                             nslots=nslots, rec_w=rec_w,
                             max_probes=max_probes)
    return ref.hash_find(table, starts, keys, mask, nslots=nslots,
                         rec_w=rec_w, max_probes=max_probes)


def hash_insert(table, starts, keys, vals, mask, *, nslots, rec_w,
                max_probes=8):
    """Batched insert-or-assign. Returns (ok (P, m), probes (P, m),
    table')."""
    if table.is_cuda:
        return _hp.hash_insert(table.contiguous(), starts.contiguous(),
                               keys.contiguous(), vals.contiguous(),
                               mask.contiguous(), nslots=nslots,
                               rec_w=rec_w, max_probes=max_probes)
    return ref.hash_insert(table, starts, keys, vals, mask, nslots=nslots,
                           rec_w=rec_w, max_probes=max_probes)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """Forward GQA attention, queries aligned to the end of the kv
    sequence: q (B, H, S, d); k/v (B, Hkv, Skv, d), any strides (a CUDA
    view needs a unit stride on d). Returns (B, H, S, d) in q's dtype;
    with return_lse also each row's log-sum-exp (B, H, S) float32."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    if return_lse:
        return ref.flash_fwd_lse(q, k, v, causal=causal, window=window)
    return ref.mha(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        lse: Tensor, do: Tensor, *, causal: bool = True,
                        window: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of flash_attention: q, o, do (B, H, S, d); k/v (B,
    Hkv, Skv, d), any strides (a CUDA view needs a unit stride on d); lse
    (B, H, S) float32 from the forward. Returns (dq, dk, dv) in the
    inputs' types."""
    if q.is_cuda:
        return _fab.flash_attention_bwd(q, k, v, o, lse.contiguous(), do,
                                        causal=causal, window=window)
    return ref.flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)


def flash_decode(q: Tensor, k: Tensor, v: Tensor, length: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """One-token GQA decode over a KV cache: q (B, H, d); k/v (B, Hkv, S,
    d), any strides (a CUDA view needs a unit stride on d); length (B,).
    Returns the flash partials (o (B, H, d), m (B, H), l (B, H)), f32."""
    if q.is_cuda:
        return _fd.flash_decode(q.contiguous(), k, v,
                                length.to(torch.int32).contiguous())
    return ref.decode_attention(q, k, v, length)


combine_decode_stats = ref.combine_decode_stats


def moe_dispatch(expert_ids: Tensor, *, n_experts: int
                 ) -> Tuple[Tensor, Tensor]:
    """Expert histogram and stable positions: expert_ids (T,) -> (counts
    (E,), position (T,)), int32."""
    if expert_ids.is_cuda:
        return _md.moe_dispatch(expert_ids.to(torch.int32).contiguous(),
                                n_experts)
    return ref.moe_dispatch(expert_ids, n_experts)


def rg_lru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t over a, b (B, S, D) float32 from h0
    (B, D) (None: zeros). Returns h (B, S, D) float32."""
    if a.is_cuda:
        return _rg.rg_lru_scan(a.contiguous(), b.contiguous(),
                               None if h0 is None else h0.contiguous())
    return ref.rg_lru_scan(a, b, h0)


def rg_lru_scan_bwd(a: Tensor, h: Tensor, h0: Optional[Tensor], dh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward of rg_lru_scan: a, h (its output), dh (B, S, D)
    float32; h0 (B, D) or None. Returns (da, db, dh0)."""
    if a.is_cuda:
        return _rg.rg_lru_scan_bwd(a.contiguous(), h.contiguous(),
                                   None if h0 is None else h0.contiguous(),
                                   dh.contiguous())
    return ref.rg_lru_scan_bwd(a, h, h0, dh)


def mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                    C0: Tensor, n0: Tensor, m0: Tensor, with_qn: bool = False
                    ) -> Tuple[Tensor, ...]:
    """The chunkwise mLSTM: q, k, v (B, S, H, hd), gate logits i, f (B, S,
    H), state C0 (B, H, hd, hd), n0 (B, H, hd), m0 (B, H), float32, in
    chunks of ref.mlstm_chunk(S). Returns (h (B, S, H, hd), C, n, m), with
    with_qn also the normalizers q . n (B, S, H) for the backward."""
    if q.is_cuda:
        return _xl.mlstm_chunkwise(*(x.contiguous() for x in (
            q, k, v, i, f, C0, n0, m0)), with_qn=with_qn)
    return ref.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, with_qn=with_qn)


def mlstm_chunkwise_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor,
                        f: Tensor, C0: Tensor, n0: Tensor, m0: Tensor,
                        h: Tensor, qn: Tensor, dh: Tensor, dC: Tensor,
                        dn: Tensor, dm: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of mlstm_chunkwise: its inputs, its outputs h and qn
    (with_qn), dh and the final state's gradients dC, dn, dm, float32.
    Returns (dq, dk, dv, di, df)."""
    if q.is_cuda:
        return _xl.mlstm_chunkwise_bwd(*(x.contiguous() for x in (
            q, k, v, i, f, C0, n0, m0, h, qn, dh, dC, dn, dm)))
    return ref.mlstm_chunkwise_bwd(q, k, v, i, f, C0, n0, m0, h, qn, dh, dC,
                                   dn, dm)


def mlstm_step(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
               C: Tensor, n: Tensor, m: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One mLSTM step: q, k, v (B, H, hd), i, f (B, H) float32; the state
    C (B, H, hd, hd), n (B, H, hd), m (B, H) float32 (contiguous on the
    card) is updated in place. Returns (h (B, H, hd), C, n, m)."""
    if q.is_cuda:
        return _xl.mlstm_step(*(x.contiguous() for x in (q, k, v, i, f)),
                              C, n, m)
    return ref.mlstm_step(q, k, v, i, f, C, n, m)


def mlstm_step_bwd(q: Tensor, k: Tensor, v: Tensor, i: Tensor, f: Tensor,
                   C: Tensor, n: Tensor, m: Tensor, dh: Tensor, dC: Tensor,
                   dn: Tensor, dm: Tensor) -> Tuple[Tensor, ...]:
    """The backward of one mLSTM step from the state (C, n, m) it entered:
    dh (B, H, hd) and the left state's gradients dC, dn, dm, float32.
    Returns (dq, dk, dv, di, df, dC, dn, dm), the last three the entering
    state's."""
    if q.is_cuda:
        return _xl.mlstm_step_bwd(*(x.contiguous() for x in (
            q, k, v, i, f, C, n, m, dh, dC, dn, dm)))
    return ref.mlstm_step_bwd(q, k, v, i, f, C, n, m, dh, dC, dn, dm)


def slstm_scan(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
               c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
               keep: bool = False) -> Tuple[Tensor, ...]:
    """The sLSTM recurrence: z, i, f, o (B, S, R) float32, rz (R, R), the
    state c0, n0, h0, m0 (B, R) float32. Returns (hs (B, S, R), c, n, h,
    m), with keep also each step's (c, n, m, tanh(z + h rz)) (4, B, S, R)
    for the backward."""
    if z.is_cuda:
        return _xl.slstm_scan(*(x.contiguous() for x in (
            z, i, f, o, rz, c0, n0, h0, m0)), keep=keep)
    return ref.slstm_scan(z, i, f, o, rz, c0, n0, h0, m0, keep=keep)


def slstm_scan_bwd(z: Tensor, i: Tensor, f: Tensor, o: Tensor, rz: Tensor,
                   c0: Tensor, n0: Tensor, h0: Tensor, m0: Tensor,
                   hs: Tensor, kept: Tensor, dhs: Tensor, dc: Tensor,
                   dn: Tensor, dh: Tensor, dm: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The backward of slstm_scan: its inputs, its outputs hs and kept
    (keep=True), dhs (B, S, R) and the final state's gradients dc, dn, dh,
    dm (B, R), float32. Returns (dz, di, df, do); dz is the
    pre-activation's gradient."""
    if z.is_cuda:
        return _xl.slstm_scan_bwd(*(x.contiguous() for x in (
            z, i, f, o, rz, c0, n0, h0, m0, hs, kept, dhs, dc, dn, dh, dm)))
    return ref.slstm_scan_bwd(z, i, f, o, rz, c0, n0, h0, m0, hs, kept, dhs,
                              dc, dn, dh, dm)
