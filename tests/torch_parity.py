"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

The same numpy inputs go to the JAX package and to its counterpart in
`repro_torch`, on the CPU, and the outputs must match bit for bit (every
value is int32 or bool). Nothing here changes global state: the JAX side
runs on its default XLA lanes (`use_pallas=False` where a signature takes
it), and torch's intra-op thread count is lowered to one for a module and
restored after it, so the torch tests do not crowd the JAX tests that share
the cores.
"""
import numpy as np
import pytest
import torch


def tt(x, dtype=None):
    """numpy (or JAX) array -> CPU tensor (int32 unless bool)."""
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.bool if a.dtype == np.bool_ else torch.int32
    return torch.as_tensor(a.astype(np.bool_ if dtype == torch.bool
                                    else np.int32))


def npy(x):
    """JAX array, torch tensor or numpy array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(a, b, what=""):
    """Assert two results are equal in shape and value (bools as ints)."""
    a, b = npy(a), npy(b)
    if a.dtype == np.bool_ or b.dtype == np.bool_:
        a, b = a.astype(np.int64), b.astype(np.int64)
    np.testing.assert_array_equal(a, b, err_msg=what)


def same_decision(td, jd, what=""):
    """Assert a port Decision equals the JAX package's field by field
    (scores to 1e-12: the same sums, possibly in another order)."""
    assert td.op.value == jd.op.value and td.promise.value == \
        jd.promise.value, what
    for f in ("arm", "skew", "source", "batch_ops", "dedup", "coalesce",
              "cached", "hit_rate", "depth", "quarantined"):
        assert getattr(td, f) == getattr(jd, f), (what, f)
    assert set(td.scores) == set(jd.scores), what
    for a, v in jd.scores.items():
        assert abs(td.scores[a] - v) <= 1e-12 * max(1.0, abs(v)), (what, a)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    """The card, for tests that need one; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card through "
                    "chip_smoke.py and tests/test_torch_cuda.py)")
    return torch.device("cuda")


def jit(fn, *static):
    """jax.jit with static keyword arguments (the JAX package's functions
    are tracer-safe): one compile per shape instead of one per primitive."""
    import jax
    return jax.jit(fn, static_argnames=static)


def amo_inputs(rng, P, L, m, span):
    """Random AMO lists: offsets drawn from a few words (repeats, CAS
    chains), some outside [0, L) both ways, every opcode 0-6 and a few
    unknown codes, small operands so CAS compares hit."""
    local = rng.integers(-4, 4, (P, L)).astype(np.int32)
    ops = np.zeros((P, m, 4), np.int32)
    ops[..., 0] = rng.integers(0, span, (P, m))
    oob = rng.random((P, m)) < 0.15
    ops[..., 0] = np.where(oob, rng.choice([-L - 3, -2, -1, L, L + 5],
                                           (P, m)), ops[..., 0])
    ops[..., 1] = rng.integers(0, 9, (P, m))
    ops[..., 2] = rng.integers(-4, 4, (P, m))
    ops[..., 3] = rng.integers(-4, 4, (P, m))
    # int32 wraparound on FAA
    big = rng.random((P, m)) < 0.1
    ops[..., 2] = np.where(big, np.int32(2 ** 31 - 1), ops[..., 2])
    mask = rng.random((P, m)) > 0.25
    return local, ops, mask


def probe_table(rng, P, nslots, vw, fill, key_span):
    """A table with READY / RESERVED / EMPTY records, reader bits on some
    flags; fill=1.0 leaves no EMPTY slot (probe exhaustion)."""
    rec_w = 2 + vw
    t = np.zeros((P, nslots, rec_w), np.int32)
    state = np.where(rng.random((P, nslots)) < fill,
                     np.where(rng.random((P, nslots)) < 0.85, 2, 1), 0)
    t[..., 0] = state + 256 * rng.integers(0, 3, (P, nslots))
    t[..., 0] = np.where(state == 0, 0, t[..., 0])
    t[..., 1] = rng.integers(0, key_span, (P, nslots))
    t[..., 2:] = rng.integers(-1000, 1000, (P, nslots, vw))
    return t.reshape(P, nslots * rec_w)


def jax_and_port_models(name, seed=0):
    """(JAX cfg, JAX params, port cfg, port model on the CPU) of the reduced
    config `name`: the JAX package's `init_params`, carried across with
    `convert.lm_from_numpy`, so both packages compute with the same
    weights."""
    import jax
    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    from repro_torch import convert
    from repro_torch.configs import registry as treg
    jcfg = jreg.get(name).reduced()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = treg.get(name).reduced()
    model = convert.lm_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  "cpu")
    return jcfg, params, tcfg, model


# ---------------------------------------------------------------------------
# The AUTO stream: one op stream through the hash table's default backend,
# replayed in the JAX package, in the port on the CPU and on the card
# ---------------------------------------------------------------------------
AUTO_P, AUTO_NSLOTS, AUTO_N = 4, 64, 6
# owner compute between dispatch points, per batch: flips the AM arms
AUTO_BUSY_US = (0.0, 0.0, 0.5, 0.0, 0.05, 0.0, 0.5, 0.0)


def auto_stream(seed=0):
    """Per batch: insert keys (P, N) with a duplicate pair in odd batches
    (dedup < 1 turns coalescing on), find keys (every inserted key of the
    batch's first half and as many never inserted), and the owner's busy
    µs. Values are derived from the key, so duplicates are identical."""
    rng = np.random.default_rng(seed)
    nb = len(AUTO_BUSY_US)
    pool = rng.choice(2 ** 20, size=2 * nb * AUTO_P * AUTO_N,
                      replace=False).astype(np.int32) + 1
    pool = pool.reshape(2 * nb, AUTO_P, AUTO_N)
    out = []
    for b, busy in enumerate(AUTO_BUSY_US):
        keys = pool[2 * b].copy()
        if b % 2:
            keys[:, 1] = keys[:, 0]
        half = AUTO_N // 2
        fkeys = np.concatenate([keys[:, :half], pool[2 * b + 1][:, :half]],
                               axis=1)
        out.append((keys, fkeys, busy))
    return out


def auto_val(keys):
    return ((np.asarray(keys) * 31 + 7) & 0x7FFFFF)[..., None]


def run_port_auto(device, params, stream=None):
    """The AUTO stream through the port's `hashtable.insert` / `find` with
    no backend argument (an AdaptiveEngine with an AM engine, policy
    "cost", measure=False, explore_every=3). Returns (arms, results,
    final window) as numpy."""
    from repro_torch.core import adaptive as ad, am
    from repro_torch.core import hashtable as ht
    from repro_torch.core.types import OpStats, Promise
    table = ht.make_hashtable(AUTO_P, AUTO_NSLOTS, 1, device=device)
    engine = am.AMEngine(AUTO_P)
    chooser = ad.AdaptiveEngine(AUTO_P, am_engine=engine, params=params,
                                explore_every=3)
    arms, results = [], []
    for keys, fkeys, busy in stream or auto_stream():
        stats = OpStats(target_busy_us=busy)
        table, ok, probes = ht.insert(
            table, torch.as_tensor(keys, device=device),
            torch.as_tensor(auto_val(keys), device=device),
            promise=Promise.CRW, engine=engine, adaptive=chooser,
            stats=stats)
        arms.append(chooser.last_decision.arm)
        table, found, vals = ht.find(
            table, torch.as_tensor(fkeys, device=device), promise=Promise.CR,
            engine=engine, adaptive=chooser, stats=stats)
        arms.append(chooser.last_decision.arm)
        results += [npy(x) for x in (ok, probes, found, vals)]
    return arms, results, npy(table.win.data)
