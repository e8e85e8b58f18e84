"""The slice as a whole, for the hosted queue: build a queue in JAX, carry
its window into the port, run one push/pop stream through both and compare
pushed / got / popped values and the final window, bit for bit. Arms: RDMA
(C_RW and C_W pushes, C_R and C_RW pops, checksum slots, coalesced ticket
FAOs, a ring that fills up) and RPC; plus the host-local C_L ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import am as jam
from repro.core import queue as jq
from repro.core.types import Promise as JPromise
from repro_torch import convert
from repro_torch.core import adaptive as tad
from repro_torch.core import am as tam
from repro_torch.core import queue as tq
from repro_torch.core.types import Promise
from torch_parity import jit, same, torch_one_thread, tt  # noqa: F401

P, N, VW = 4, 6, 2
j_push = jit(jq.push_rdma, "promise", "max_cas_rounds", "planned",
             "coalesce")
j_pop = jit(jq.pop_rdma, "n", "promise", "max_cas_rounds", "planned",
            "coalesce")
j_push_rpc = jit(jq.push_rpc, "engine")
j_pop_rpc = jit(jq.pop_rpc, "engine", "n")


def _vals(seed, batches):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, (batches, P, N, VW)
                        ).astype(np.int32)


def _carry(qj):
    return convert.queue_from_numpy(np.asarray(qj.win.data), qj.host,
                                    qj.capacity, qj.val_words, qj.checksum,
                                    device="cpu")


@pytest.mark.parametrize("push_p,pop_p,checksum,coalesce", [
    ("CRW", "CR", False, False),
    ("CW", "CRW", False, False),
    ("CRW", "CRW", True, False),
    ("CRW", "CR", False, True),
])
def test_rdma_stream_matches_jax(push_p, pop_p, checksum, coalesce):
    """Pushes then pops, the ring (capacity 40) filling on the last push
    batch so the overflow path returns tickets; every pop batch compared."""
    vals = _vals(1, 3)
    valid = np.random.default_rng(2).random((3, P, N)) > 0.15
    qj = jq.make_queue(P, host=1, capacity=40, val_words=VW,
                       checksum=checksum)
    qj, _ = j_push(qj, jnp.asarray(vals[0]), promise=JPromise[push_p])
    qt = _carry(qj)
    for b in (1, 2):
        qj, okj = j_push(qj, jnp.asarray(vals[b]), promise=JPromise[push_p],
                         valid=jnp.asarray(valid[b]), coalesce=coalesce)
        qt, okt = tq.push_rdma(qt, tt(vals[b]), promise=Promise[push_p],
                               valid=tt(valid[b]), coalesce=coalesce)
        same(okt, okj, f"pushed {b}")
        same(convert.to_numpy(qt), qj.win.data, f"window after push {b}")
    assert not bool(okt.all())            # the ring filled up
    for b in range(3):
        qj, gj, vj = j_pop(qj, n=N, promise=JPromise[pop_p],
                           coalesce=coalesce)
        qt, gt, vt = tq.pop_rdma(qt, N, promise=Promise[pop_p],
                                 coalesce=coalesce)
        same(gt, gj, f"got {b}")
        same(vt, vj, f"vals {b}")
        same(convert.to_numpy(qt), qj.win.data, f"window after pop {b}")


@pytest.mark.parametrize("checksum", [False, True])
def test_rpc_stream_matches_jax(checksum):
    vals = _vals(3, 3)
    qj = jq.make_queue(P, host=0, capacity=40, val_words=VW,
                       checksum=checksum)
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    jq.build_am_handlers(qj, ej)
    qj, _ = j_push_rpc(qj, ej, jnp.asarray(vals[0]))
    qt = _carry(qj)
    tq.build_am_handlers(qt, et)
    valid = np.random.default_rng(4).random((P, N)) > 0.2
    qj, okj = j_push_rpc(qj, ej, jnp.asarray(vals[1]),
                         valid=jnp.asarray(valid))
    qt, okt = tq.push_rpc(qt, et, tt(vals[1]), valid=tt(valid))
    same(okt, okj)
    same(convert.to_numpy(qt), qj.win.data)
    for b in range(3):
        qj, gj, vj = j_pop_rpc(qj, ej, n=N)
        qt, gt, vt = tq.pop_rpc(qt, et, N)
        same(gt, gj, f"got {b}")
        same(vt, vj, f"vals {b}")
        same(convert.to_numpy(qt), qj.win.data, f"window after pop {b}")


def test_local_ops_and_front_doors_match_jax():
    """C_L push/pop at the host, and push/pop front doors for explicit
    backends on the same stream; with no backend argument (AUTO) the
    chooser runs an arm whose result equals the same fixed arm's."""
    vals = _vals(5, 2)
    qj = jq.make_queue(P, host=2, capacity=16, val_words=VW)
    qt = _carry(qj)
    lv = vals[0].reshape(-1, VW)[:10]
    qj, okj = jq.push_local(qj, jnp.asarray(lv))
    qt, okt = tq.push(qt, tt(lv), promise=Promise.CL)
    same(okt, okj)
    same(convert.to_numpy(qt), qj.win.data)
    qj, gj, vj = jq.pop_local(qj, 4)
    qt, gt, vt = tq.pop(qt, 4, promise=Promise.CL)
    same(gt, gj)
    same(vt, vj)
    same(convert.to_numpy(qt), qj.win.data)
    qj, okj = j_push(qj, jnp.asarray(vals[1]), promise=JPromise.CW)
    qt, okt = tq.push(qt, tt(vals[1]), promise=Promise.CW, backend="rdma")
    same(okt, okj)
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    jq.build_am_handlers(qj, ej)
    tq.build_am_handlers(qt, et)
    qj, gj, vj = j_pop_rpc(qj, ej, n=N)
    qt, gt, vt = tq.pop(qt, N, backend="rpc", engine=et)
    same(gt, gj)
    same(vt, vj)
    same(convert.to_numpy(qt), qj.win.data)
    a = tad.AdaptiveEngine(P, am_engine=et)
    qa, oka = tq.push(qt, tt(vals[1]), engine=et, adaptive=a)
    arm = a.last_decision.arm
    if arm in ("am", "am_pt"):
        qr, okr = tq.push(qt, tt(vals[1]), backend="rpc", engine=et)
    else:
        qr, okr = tq.push(qt, tt(vals[1]), backend="rdma",
                          planned=arm == "rdma_fused")
    same(oka, okr)
    same(convert.to_numpy(qa), convert.to_numpy(qr))
