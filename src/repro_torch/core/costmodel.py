"""Model-layer backend choosers (port of the last part of
`repro.core.costmodel`, lines 617-656): the same move-data-vs-move-compute
decision the data structures make, applied to the serving stack. The rest
of the cost model (component costs, per-op predictions, calibration) is
not ported yet.
"""
from __future__ import annotations

from .types import Backend


def moe_dispatch_bytes(backend: Backend, *, tokens_per_rank: int,
                       d_model: int, expert_bytes_per_rank: int,
                       dtype_bytes: int = 2) -> int:
    """Bytes crossing the network per rank per layer for MoE dispatch.

    RPC  = ship activations to expert owners and back (2 x token bytes);
    RDMA = pull the expert weight blocks to the data owner (1 x weights).
    """
    if backend == Backend.RPC:
        return 2 * tokens_per_rank * d_model * dtype_bytes
    return expert_bytes_per_rank


def choose_moe_backend(**kw) -> Backend:
    rpc = moe_dispatch_bytes(Backend.RPC, **kw)
    rdma = moe_dispatch_bytes(Backend.RDMA, **kw)
    return Backend.RPC if rpc <= rdma else Backend.RDMA


def attention_gather_bytes(backend: Backend, *, kv_bytes_per_shard: int,
                           q_heads: int, head_dim: int, shards: int,
                           dtype_bytes: int = 2) -> int:
    """Distributed decode attention: RDMA = gather remote KV pages to the
    query owner; RPC = ship the query, compute partial attention at each KV
    shard, return (m, l, o) flash stats, bytes independent of cache length.
    """
    if backend == Backend.RDMA:
        return (shards - 1) * kv_bytes_per_shard
    stats_bytes = q_heads * (head_dim + 2) * 4  # o + (m, l) in f32
    query_bytes = q_heads * head_dim * dtype_bytes
    return (shards - 1) * (query_bytes + stats_bytes)


def choose_attention_backend(**kw) -> Backend:
    rdma = attention_gather_bytes(Backend.RDMA, **kw)
    rpc = attention_gather_bytes(Backend.RPC, **kw)
    return Backend.RDMA if rdma <= rpc else Backend.RPC
