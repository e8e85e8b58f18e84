"""Phase-count regression on the port: the DESIGN.md §2 exchange table
(put 1, get / cas / fao 2, AM dispatch 2, reply-elided dispatch 1, and ONE
occupancy (mask) exchange per planned batch), counted through the port's
`routing.sharding_hook` as tests/test_phase_counts.py counts the JAX
package's.

Each test makes the same calls at the same P and sizes in both packages,
on the same numpy inputs: every count must equal the absolute number the
JAX test pins and the JAX package's count of the same call, and the roles
of the exchanges (request, reply, mask) must come in the same order. The
JAX calls are traced (`jax.make_jaxpr`), not run: the hook fires while
Python walks the function, so a trace counts what an eager call counts
(a `while_loop` body once, either way) without compiling every primitive
at every P, which took most of a minute here. The port's calls run.

tests/test_phase_counts.py's second half (`test_hlo_*` and
tests/phase_count_probe.py) counts all-to-alls in XLA's sharded HLO; the
port has no compiler pass to count in, so that half has no twin here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as jam
from repro.core import costmodel as jcm
from repro.core import hashtable as jht
from repro.core import queue as jq
from repro.core import routing as jrouting
from repro.core import window as jwin
from repro.core.types import AmoKind as JAmoKind
from repro.core.types import Backend as JBackend
from repro.core.types import Promise as JPromise
from repro_torch.core import am as tam
from repro_torch.core import costmodel as tcm
from repro_torch.core import hashtable as tht
from repro_torch.core import queue as tq
from repro_torch.core import routing as trouting
from repro_torch.core import window as twin
from repro_torch.core.types import AmoKind, Backend, Promise
from torch_parity import torch_one_thread  # noqa: F401

P = 4
DEV = "cpu"


class ExchangeCounter:
    """Counts exchanges by role through one package's sharding hook (each
    exchange calls the hook twice: role_pre and role_post)."""

    def __init__(self, routing, call=lambda fn: fn()):
        self.routing, self.call, self.roles = routing, call, []

    def hook(self, x, role):
        if role.endswith("_pre"):
            self.roles.append(role[:-4])
        return x

    def run(self, fn):
        self.roles = []
        with self.routing.sharding_hook(self.hook):
            self.call(fn)
        return len(self.roles)

    def mask_exchanges(self):
        return sum(1 for r in self.roles if r.endswith("_mask"))


def _trace(fn):
    """Walk a JAX call under jax.make_jaxpr: its exchanges are staged, not
    run."""
    jax.make_jaxpr(lambda: (fn(), jnp.int32(0))[1])()


class Both:
    """The JAX package's counter and the port's, run on the same call."""

    def __init__(self):
        self.j = ExchangeCounter(jrouting, _trace)
        self.t = ExchangeCounter(trouting)

    def run(self, jfn, tfn):
        """Both calls' exchange counts, which must agree role by role."""
        nj, nt = self.j.run(jfn), self.t.run(tfn)
        assert self.t.roles == self.j.roles, (self.t.roles, self.j.roles)
        assert nt == nj
        return nt

    def mask_exchanges(self):
        assert self.t.mask_exchanges() == self.j.mask_exchanges()
        return self.t.mask_exchanges()


def i32(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def _fixtures():
    """(dst, off, window, vals) of the JAX test in both packages."""
    rng = np.random.default_rng(0)
    dst = rng.integers(0, P, (P, 6)).astype(np.int32)
    off = rng.integers(0, 32, (P, 6)).astype(np.int32)
    vals = np.ones((P, 6, 2), np.int32)
    j = (jnp.asarray(dst), jnp.asarray(off), jwin.make_window(P, 64),
         jnp.asarray(vals))
    t = (i32(dst), i32(off), twin.make_window(P, 64, device=DEV), i32(vals))
    return j, t


def _echo_and_fire(eng_j, eng_t):
    """The echo handler (one reply word) and the reply-elided fire handler
    in each package: JAX's per owner, the port's over all owners."""
    je = eng_j.register("echo", lambda l, p, m: (l, p[:, :1]),
                        reply_width=1)
    jf = eng_j.register("fire", lambda l, p, m: (l + p.sum(), p[:, :0]),
                        reply_width=0)
    te = eng_t.register("echo", lambda l, p, m: (l, p[..., :1]),
                        reply_width=1)
    tf = eng_t.register("fire", lambda l, p, m: (
        l + p.sum(dim=(1, 2))[:, None], p[..., :0]), reply_width=0)
    return (je, jf), (te, tf)


def test_plan_exchanges_constant_matches_jax():
    assert tcm.PLAN_EXCHANGES == jcm.PLAN_EXCHANGES == 1


def test_component_op_exchange_table_planned():
    """The §2 component table on the planned engine: put=1, get=2, cas=2,
    fao=2 exchanges, and none of them is a mask exchange."""
    (jd, jo, jw, jv), (td, to, tw, tv) = _fixtures()
    jp, tp = jrouting.make_plan(jd, cap=6), trouting.make_plan(td, cap=6)
    c = Both()
    assert c.run(lambda: jwin.rdma_put(jw, jd, jo, jv, plan=jp),
                 lambda: twin.rdma_put(tw, td, to, tv, plan=tp)) == 1
    assert c.mask_exchanges() == 0
    assert c.run(lambda: jwin.rdma_get(jw, jd, jo, 2, plan=jp),
                 lambda: twin.rdma_get(tw, td, to, 2, plan=tp)) == 2
    assert c.run(lambda: jwin.rdma_cas(jw, jd, jo, 0, 1, plan=jp),
                 lambda: twin.rdma_cas(tw, td, to, 0, 1, plan=tp)) == 2
    assert c.run(
        lambda: jwin.rdma_fao(jw, jd, jo, 1, JAmoKind.FAA, plan=jp),
        lambda: twin.rdma_fao(tw, td, to, 1, AmoKind.FAA, plan=tp)) == 2
    # fused descriptors are ordinary two-exchange component ops
    assert c.run(
        lambda: jwin.rdma_cas_put(jw, jd, jo, 0, 1, jo + 1, jv, plan=jp),
        lambda: twin.rdma_cas_put(tw, td, to, 0, 1, to + 1, tv,
                                  plan=tp)) == 2
    assert c.run(
        lambda: jwin.rdma_fao_get(jw, jd, jo, 1, JAmoKind.FAA, jo, 2,
                                  plan=jp),
        lambda: twin.rdma_fao_get(tw, td, to, 1, AmoKind.FAA, to, 2,
                                  plan=tp)) == 2


def test_component_op_exchange_table_unplanned():
    """Unplanned route() pays one extra occupancy-mask exchange per phase
    (engine-level 2 for put, 3 for two-phase ops)."""
    (jd, jo, jw, jv), (td, to, tw, tv) = _fixtures()
    c = Both()
    assert c.run(lambda: jwin.rdma_put(jw, jd, jo, jv),
                 lambda: twin.rdma_put(tw, td, to, tv)) == 2
    assert c.mask_exchanges() == 1
    assert c.run(lambda: jwin.rdma_cas(jw, jd, jo, 0, 1),
                 lambda: twin.rdma_cas(tw, td, to, 0, 1)) == 3
    assert c.mask_exchanges() == 1


def test_am_dispatch_exchange_table():
    """AM dispatch = 2 exchanges; reply-elided (reply_width=0) = 1; the
    plan's occupancy exchange happens once at plan time, not per
    dispatch."""
    (jd, _, _, jv), (td, _, _, tv) = _fixtures()
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    (jecho, jfire), (techo, tfire) = _echo_and_fire(ej, et)
    js, ts = jnp.zeros((P, 4), jnp.int32), torch.zeros((P, 4),
                                                       dtype=torch.int32)
    jp, tp = jrouting.make_plan(jd, cap=6), trouting.make_plan(td, cap=6)
    c = Both()
    assert c.run(lambda: ej.dispatch(jecho, js, jd, jv, plan=jp),
                 lambda: et.dispatch(techo, ts, td, tv, plan=tp)) == 2
    assert c.run(lambda: ej.dispatch(jfire, js, jd, jv, plan=jp),
                 lambda: et.dispatch(tfire, ts, td, tv, plan=tp)) == 1
    # unplanned: +1 mask exchange riding with the request
    assert c.run(lambda: ej.dispatch(jecho, js, jd, jv),
                 lambda: et.dispatch(techo, ts, td, tv)) == 3
    assert c.mask_exchanges() == 1


def _ht_keys(p):
    keys = np.arange(p * 4, dtype=np.int32).reshape(p, 4) + 1
    return keys, np.stack([keys, keys], axis=-1)


def _tables(p, nslots):
    """A JAX table of `p` ranks (empty: its trace does not read the
    values) and the port's, holding _ht_keys(p)."""
    keys, vals = _ht_keys(p)
    tt, _, _ = tht.insert_rdma(tht.make_hashtable(p, nslots, 2, device=DEV),
                               i32(keys), i32(vals), promise=Promise.CRW)
    return jht.make_hashtable(p, nslots, 2), tt


def _one_occupancy_exchange(p, nslots):
    """A fused find and a fused insert of p x 4 keys each exchange the
    occupancy mask exactly once; returns the Both counter."""
    keys, vals = _ht_keys(p)
    jt, tt = _tables(p, nslots)
    jk, tk = jnp.asarray(keys), i32(keys)
    c = Both()
    c.run(lambda: jht.find_rdma(jt, jk, promise=JPromise.CRW, max_probes=1,
                                fused=True)[1],
          lambda: tht.find_rdma(tt, tk, promise=Promise.CRW, max_probes=1,
                                fused=True)[1])
    assert c.mask_exchanges() == tcm.PLAN_EXCHANGES == 1
    c.run(lambda: jht.insert_rdma(
        jht.make_hashtable(p, nslots, 2), jk, jnp.asarray(vals),
        promise=JPromise.CRW, max_probes=1, fused=True)[0].win.data,
        lambda: tht.insert_rdma(
            tht.make_hashtable(p, nslots, 2, device=DEV), tk, i32(vals),
            promise=Promise.CRW, max_probes=1, fused=True)[0].win.data)
    assert c.mask_exchanges() == 1
    return c, (jt, tt, jk, tk)


def test_planned_batch_has_one_occupancy_exchange():
    """A planned probe loop exchanges the occupancy mask exactly ONCE per
    batch (at plan time); every later phase ships payload only."""
    c, (jt, tt, jk, tk) = _one_occupancy_exchange(P, 32)
    # unfused engine: one mask exchange per phase instead
    c.run(lambda: jht.find_rdma(jt, jk, promise=JPromise.CRW, max_probes=1,
                                fused=False)[1],
          lambda: tht.find_rdma(tt, tk, promise=Promise.CRW, max_probes=1,
                                fused=False)[1])
    assert c.mask_exchanges() == 3  # lock FAO + get + unlock FAO


def test_coalescing_adds_zero_exchanges():
    """The §6 pin: sender-side coalescing is local compute. A coalesced
    component phase issues the planned engine's exchange counts (put=1,
    get/cas/fao=2), a coalesce_plan pays the same ONE occupancy exchange
    as make_plan, and a coalesced AM dispatch stays at 2 exchanges."""
    (jd, jo, jw, jv), (td, to, tw, tv) = _fixtures()
    jhot, thot = jnp.zeros_like(jo), torch.zeros_like(to)
    c = Both()
    # phase-local coalescing, unplanned: the unplanned engine's counts
    assert c.run(lambda: jwin.rdma_put(jw, jd, jhot, jv, coalesce=True),
                 lambda: twin.rdma_put(tw, td, thot, tv,
                                       coalesce=True)) == 2
    assert c.run(
        lambda: jwin.rdma_fao(jw, jd, jhot, 1, JAmoKind.FAA,
                              coalesce=True)[1].data,
        lambda: twin.rdma_fao(tw, td, thot, 1, AmoKind.FAA,
                              coalesce=True)[1].data) == 3
    # coalesce_plan: ONE occupancy exchange, exactly PLAN_EXCHANGES
    assert c.run(lambda: jrouting.coalesce_plan(jd, jhot, cap=6).plan.mask,
                 lambda: trouting.coalesce_plan(td, thot,
                                                cap=6).plan.mask) == 1
    assert c.mask_exchanges() == tcm.PLAN_EXCHANGES == 1
    jcp = jrouting.coalesce_plan(jd, jhot, cap=6)
    tcp = trouting.coalesce_plan(td, thot, cap=6)
    assert c.run(lambda: jwin.rdma_get(jw, jd, jhot, 2, plan=jcp),
                 lambda: twin.rdma_get(tw, td, thot, 2, plan=tcp)) == 2
    assert c.mask_exchanges() == 0
    assert c.run(lambda: jwin.rdma_cas(jw, jd, jhot, 0, 1,
                                       plan=jcp)[1].data,
                 lambda: twin.rdma_cas(tw, td, thot, 0, 1,
                                       plan=tcp)[1].data) == 2
    assert c.run(
        lambda: jwin.rdma_fao_get(jw, jd, jhot, 1, JAmoKind.FAA, jhot, 2,
                                  plan=jcp)[2].data,
        lambda: twin.rdma_fao_get(tw, td, thot, 1, AmoKind.FAA, thot, 2,
                                  plan=tcp)[2].data) == 2
    # coalesced AM dispatch: the paper's 2-exchange round trip, unchanged
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    (jecho, _), (techo, _) = _echo_and_fire(ej, et)
    js, ts = jnp.zeros((P, 4), jnp.int32), torch.zeros((P, 4),
                                                       dtype=torch.int32)
    jp, tp = jrouting.make_plan(jd, cap=6), trouting.make_plan(td, cap=6)
    assert c.run(lambda: ej.dispatch(jecho, js, jd, jv, plan=jp,
                                     coalesce=True),
                 lambda: et.dispatch(techo, ts, td, tv, plan=tp,
                                     coalesce=True)) == 2


def test_coalesced_fused_insert_exchanges_match_uncoalesced():
    """A coalesced fused C_RW insert pays ONE plan occupancy exchange and a
    request / reply pair per probe phase, as the uncoalesced one does,
    while on a duplicate-heavy batch it runs fewer probe phases: every
    duplicate group resolves with its representative's first claim, as
    the returned probe counts show. JAX counts the traced loop body once
    (1 + 2 exchanges for both); the port runs its loop eagerly and counts
    each phase it runs, 1 + 2 x the phases: 13 uncoalesced (6 probes), 3
    coalesced, JAX's trace count."""
    keys = np.broadcast_to(np.arange(1, P + 1, dtype=np.int32)[:, None],
                           (P, 6)).astype(np.int32)  # 6 dups per origin
    vals = np.stack([keys, keys], axis=-1)

    def jins(coalesce):
        return jht.insert_rdma(jht.make_hashtable(P, 64, 2),
                               jnp.asarray(keys), jnp.asarray(vals),
                               promise=JPromise.CRW, max_probes=8,
                               fused=True, coalesce=coalesce)

    def tins(coalesce):
        return tht.insert_rdma(tht.make_hashtable(P, 64, 2, device=DEV),
                               i32(keys), i32(vals), promise=Promise.CRW,
                               max_probes=8, fused=True, coalesce=coalesce)

    c = Both()
    j_unc = c.j.run(lambda: jins(False)[0].win.data)
    j_co = c.j.run(lambda: jins(True)[0].win.data)
    assert c.j.mask_exchanges() == 1  # still ONE plan occupancy exchange
    assert j_co == j_unc == 3         # zero extra exchanges, trace-level
    for coalesce, probes in ((False, 6), (True, 1)):
        got = c.t.run(lambda: tins(coalesce)[0].win.data)
        assert c.t.mask_exchanges() == tcm.PLAN_EXCHANGES == 1
        assert got == tcm.PLAN_EXCHANGES + 2 * probes, (coalesce, got)
        assert c.t.roles == c.j.roles[:1] + c.j.roles[1:] * probes
        assert int(jins(coalesce)[2].max()) == int(
            tins(coalesce)[2].max()) == probes


@pytest.mark.parametrize("planned", [False, True])
def test_queue_exchange_counts_agree_with_costmodel(planned):
    """Queue push/pop engine exchanges equal costmodel.exchange_count (the
    §2 table) in both packages, plus the plan's occupancy exchange when
    planned."""
    vals = np.ones((P, 5, 2), np.int32)
    c = Both()
    for jpr, tpr in ((JPromise.CRW, Promise.CRW), (JPromise.CW, Promise.CW)):
        got = c.run(
            lambda: jq.push_rdma(jq.make_queue(P, 0, 64, 2),
                                 jnp.asarray(vals), promise=jpr,
                                 planned=planned,
                                 max_cas_rounds=1)[0].win.data,
            lambda: tq.push_rdma(tq.make_queue(P, 0, 64, 2, device=DEV),
                                 i32(vals), promise=tpr, planned=planned,
                                 max_cas_rounds=1)[0].win.data)
        want = tcm.exchange_count(tcm.DSOp.Q_PUSH, tpr, Backend.RDMA,
                                  fused=planned)
        assert want == jcm.exchange_count(jcm.DSOp.Q_PUSH, jpr,
                                          JBackend.RDMA, fused=planned)
        assert got == want + (tcm.PLAN_EXCHANGES if planned else 0), (
            tpr, got, want)
    for jpr, tpr in ((JPromise.CRW, Promise.CRW), (JPromise.CR, Promise.CR)):
        # the JAX queue stays empty: its trace does not read the values
        jqu = jq.make_queue(P, 0, 64, 2)
        tqu, _ = tq.push_rdma(tq.make_queue(P, 0, 64, 2, device=DEV),
                              i32(vals), promise=Promise.CW)
        got = c.run(
            lambda: jq.pop_rdma(jqu, 5, promise=jpr, planned=planned,
                                max_cas_rounds=1)[0].win.data,
            lambda: tq.pop_rdma(tqu, 5, promise=tpr, planned=planned,
                                max_cas_rounds=1)[0].win.data)
        want = tcm.exchange_count(tcm.DSOp.Q_POP, tpr, Backend.RDMA,
                                  fused=planned)
        assert want == jcm.exchange_count(jcm.DSOp.Q_POP, jpr,
                                          JBackend.RDMA, fused=planned)
        assert got == want + (tcm.PLAN_EXCHANGES if planned else 0), (
            tpr, got, want)


def test_rpc_exchange_count_constant_in_handler_complexity():
    """The paper's central RPC property at the engine level: dispatch costs
    the same exchanges whether the handler is an echo or a full sequential
    hash-table probe loop."""
    keys = np.arange(P * 4, dtype=np.int32).reshape(P, 4) + 1
    jt, tt = jht.make_hashtable(P, 64, 1), tht.make_hashtable(P, 64, 1,
                                                                device=DEV)
    ej, et = jam.AMEngine(P), tam.AMEngine(P)
    jht.build_am_handlers(jt, ej)
    tht.build_am_handlers(tt, et)
    jk, tk = jnp.asarray(keys), i32(keys)
    c = Both()
    got_insert = c.run(
        lambda: jht.insert_rpc(jt, ej, jk, jk[..., None])[0].win.data,
        lambda: tht.insert_rpc(tt, et, tk, tk[..., None])[0].win.data)
    got_find = c.run(lambda: jht.find_rpc(jt, ej, jk)[0],
                     lambda: tht.find_rpc(tt, et, tk)[0])
    # unplanned dispatch: request + mask + reply = 3 engine exchanges,
    # independent of what the handler does
    assert got_insert == got_find == tcm.exchange_count(
        tcm.DSOp.HT_INSERT, Promise.CRW, Backend.RPC, fused=False) == 3


# ---------------------------------------------------------------------------
# Scale-parameterized phase counts (DESIGN.md §9): the §2 exchange table is
# independent of P, pinned at P = 16 and 64.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale_p", (16, 64))
def test_exchange_counts_p_independent(scale_p):
    """Planned put=1, get=2, cas=2, fao=2, AM dispatch=2, plan
    occupancy=1 at P = 16 and 64, the P = 4 table above."""
    rng = np.random.default_rng(scale_p)
    dst = rng.integers(0, scale_p, (scale_p, 4)).astype(np.int32)
    off = rng.integers(0, 32, (scale_p, 4)).astype(np.int32)
    vals = np.ones((scale_p, 4, 2), np.int32)
    jd, jo, jv = jnp.asarray(dst), jnp.asarray(off), jnp.asarray(vals)
    td, to, tv = i32(dst), i32(off), i32(vals)
    jw = jwin.make_window(scale_p, 64)
    tw = twin.make_window(scale_p, 64, device=DEV)
    jp, tp = jrouting.make_plan(jd, cap=4), trouting.make_plan(td, cap=4)
    c = Both()
    assert c.run(lambda: jwin.rdma_put(jw, jd, jo, jv, plan=jp),
                 lambda: twin.rdma_put(tw, td, to, tv, plan=tp)) == 1
    assert c.run(lambda: jwin.rdma_get(jw, jd, jo, 2, plan=jp),
                 lambda: twin.rdma_get(tw, td, to, 2, plan=tp)) == 2
    assert c.run(lambda: jwin.rdma_cas(jw, jd, jo, 0, 1, plan=jp),
                 lambda: twin.rdma_cas(tw, td, to, 0, 1, plan=tp)) == 2
    assert c.run(
        lambda: jwin.rdma_fao(jw, jd, jo, 1, JAmoKind.FAA, plan=jp),
        lambda: twin.rdma_fao(tw, td, to, 1, AmoKind.FAA, plan=tp)) == 2
    assert c.run(lambda: jrouting.make_plan(jd, cap=4).mask,
                 lambda: trouting.make_plan(td, cap=4).mask) == 1
    assert c.mask_exchanges() == tcm.PLAN_EXCHANGES == 1
    ej, et = jam.AMEngine(scale_p), tam.AMEngine(scale_p)
    (jecho, _), (techo, _) = _echo_and_fire(ej, et)
    js = jnp.zeros((scale_p, 4), jnp.int32)
    ts = torch.zeros((scale_p, 4), dtype=torch.int32)
    assert c.run(lambda: ej.dispatch(jecho, js, jd, jv, plan=jp),
                 lambda: et.dispatch(techo, ts, td, tv, plan=tp)) == 2


@pytest.mark.parametrize("scale_p", (16, 64))
def test_planned_ht_batch_one_occupancy_exchange_at_scale(scale_p):
    """A fused hash-table batch at P = 16 and 64 still exchanges the
    occupancy mask exactly ONCE (at plan time), and the coalesce plan's
    occupancy equals the plain plan's on distinct traffic, in both
    packages."""
    _one_occupancy_exchange(scale_p, 64)
    rng = np.random.default_rng(scale_p + 1)
    dst = rng.integers(0, scale_p, (scale_p, 5)).astype(np.int32)
    off = rng.integers(0, 64, (scale_p, 5)).astype(np.int32)
    plain = trouting.make_plan(i32(dst), cap=5)
    co = trouting.coalesce_plan(i32(dst), i32(off), cap=5)
    np.testing.assert_array_equal(plain.mask.numpy(), co.plan.mask.numpy())
    jplain = jrouting.make_plan(jnp.asarray(dst), cap=5)
    np.testing.assert_array_equal(plain.mask.numpy(),
                                  np.asarray(jplain.mask))
