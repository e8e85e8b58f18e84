"""On the card: the CUDA kernels against their plain versions, the port's
op streams on CUDA against the same streams on the CPU, and a reduced
model's decode steps on CUDA against the CPU. Every test
here takes the `cuda_device` fixture, which skips it where torch sees no
card. The file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import am, hashtable as ht, queue as dq
from repro_torch.models import lm
from repro_torch.core.types import Promise
from repro_torch.kernels import lane_cases, ops as kops
from repro_torch.kernels import ref as kref
from torch_parity import (amo_inputs, cuda_device, probe_table,  # noqa: F401
                          run_port_auto, same)


def _on(dev, *xs):
    return [torch.as_tensor(np.asarray(x)).to(dev) for x in xs]


def test_owner_lane_kernels_match_plain_versions(cuda_device):
    rng = np.random.default_rng(11)
    local, ops, mask = _on(cuda_device, *amo_inputs(rng, 4, 64, 96, 8))
    for x, y in zip(kops.amo_apply(local, ops, mask),
                    kref.amo_apply(local, ops, mask)):
        same(x, y)
    for V, G in ((2, 3), (0, 1)):
        desc = np.concatenate([
            np.stack([rng.integers(-2, 10, (4, 96)),
                      rng.integers(0, 12, (4, 96)),
                      rng.integers(0, 4, (4, 96)),
                      rng.integers(0, 10, (4, 96)),
                      rng.integers(-3, 67, (4, 96)),
                      rng.integers(-5, 5, (4, 96))], -1),
            rng.integers(0, 99, (4, 96, V))], -1)
        (d,) = _on(cuda_device, desc.astype(np.int32))
        for x, y in zip(kops.fused_apply(local, d, mask, reply_width=1 + G),
                        kref.fused_apply(local, d, mask, reply_width=1 + G)):
            same(x, y)


@pytest.mark.parametrize("fill", [0.6, 1.0])
def test_handler_kernels_match_plain_versions(cuda_device, fill):
    rng = np.random.default_rng(12)
    table, starts, keys, vals, mask = _on(
        cuda_device, probe_table(rng, 3, 32, 2, fill, key_span=12),
        rng.integers(0, 32, (3, 40)).astype(np.int32),
        rng.integers(0, 12, (3, 40)).astype(np.int32),
        rng.integers(0, 9, (3, 40, 2)).astype(np.int32),
        rng.random((3, 40)) > 0.2)
    kw = dict(nslots=32, rec_w=4, max_probes=8)
    for x, y in zip(kops.hash_find(table, starts, keys, mask, **kw),
                    kref.hash_find(table, starts, keys, mask, **kw)):
        same(x, y)
    for x, y in zip(kops.hash_insert(table, starts, keys, vals, mask, **kw),
                    kref.hash_insert(table, starts, keys, vals, mask, **kw)):
        same(x, y)


def _streams(dev):
    """Hash-table inserts and finds on every arm, queue pushes and pops on
    both, at P = 4; returns every reply and window."""
    rng = np.random.default_rng(13)
    P, n = 4, 16
    keys = torch.as_tensor(rng.choice(2 ** 20, (2, P, n), replace=False)
                           .astype(np.int32), device=dev)
    vals = (keys * 5)[..., None]
    out = []
    for arm in ("fused", "unfused", "rpc"):
        t = ht.make_hashtable(P, 64, 1, device=dev)
        eng = am.AMEngine(P)
        ht.build_am_handlers(t, eng)
        for b in range(2):
            if arm == "rpc":
                t, ok, pr = ht.insert_rpc(t, eng, keys[b], vals[b])
                found, v = ht.find_rpc(t, eng, keys[b] ^ (b << 21))
            else:
                t, ok, pr = ht.insert_rdma(t, keys[b], vals[b],
                                           fused=arm == "fused")
                t, found, v = ht.find_rdma(t, keys[b] ^ (b << 21),
                                           promise=Promise.CRW,
                                           fused=arm == "fused")
            out += [ok, pr, found, v, t.win.data]
    for arm in ("rdma", "rpc"):
        q = dq.make_queue(P, 1, 128, 2, device=dev)
        eng = am.AMEngine(P)
        dq.build_am_handlers(q, eng)
        items = torch.stack([keys[0], keys[1]], -1)
        if arm == "rpc":
            q, ok = dq.push_rpc(q, eng, items)
            q, got, v = dq.pop_rpc(q, eng, n)
        else:
            q, ok = dq.push_rdma(q, items)
            q, got, v = dq.pop_rdma(q, n, promise=Promise.CRW)
        out += [ok, got, v, q.win.data]
    return [x.cpu() for x in out]


def test_streams_on_cuda_equal_cpu(cuda_device):
    for g, c in zip(_streams(cuda_device), _streams("cpu")):
        same(g, c)


@pytest.mark.parametrize("T,E", [(1, 64), (48, 64), (300, 7), (6144, 64)])
def test_moe_dispatch_kernel_matches_plain_version(cuda_device, T, E):
    """Bit for bit, ids outside [0, E) included (they follow the plain
    version: no count, the wrapped column for [-E, 0), else INT32_MIN)."""
    rng = np.random.default_rng(T + E)
    ids = rng.integers(0, E, T)
    bad = rng.random(T) < 0.1
    ids[bad] = rng.integers(-2 * E, 2 * E, int(bad.sum()))
    (x,) = _on(cuda_device, ids.astype(np.int32))
    for a, b in zip(kops.moe_dispatch(x, n_experts=E),
                    kref.moe_dispatch(x, E)):
        same(a, b)


def _decode_close(got, want):
    """chip_smoke.py's DECODE_TOL: o / l within 1e-4 relative plus 1e-5
    (f32 math over bf16 or f32 inputs, another summation order, an online
    softmax and a merge of split partials), m within 1e-5, l within 1e-4
    relative."""
    (o, m, l), (o_r, m_r, l_r) = got, want
    torch.testing.assert_close(m, m_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-4, atol=0)
    torch.testing.assert_close(o / l.clamp(min=1e-30)[..., None],
                               o_r / l_r.clamp(min=1e-30)[..., None],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("g,dtype", [(1, torch.float32), (8, torch.float32),
                                     (1, torch.bfloat16), (3, torch.bfloat16),
                                     (16, torch.bfloat16),
                                     (16, torch.float32)])
def test_flash_decode_kernel_matches_plain_version(cuda_device, g, dtype):
    """On a (B, W, Hkv, d) cache read through a transposed view (W = 200,
    not a multiple of the kernel's key chunk c), lengths 0, 1, c - 1, c,
    c + 1 (a split boundary and either side of it), 131, W - 1 and W; d
    128, and 256 at g = 16."""
    from repro_torch.kernels.flash_decode import KEY_CHUNK as c
    rng = np.random.default_rng(g)
    B, Hkv, W, d = 8, 2, 200, 256 if g == 16 else 128
    q, ck, cv = _on(cuda_device, rng.normal(size=(B, Hkv * g, d)),
                    rng.normal(size=(B, W, Hkv, d)),
                    rng.normal(size=(B, W, Hkv, d)))
    q, ck, cv = q.to(dtype), ck.to(dtype), cv.to(dtype)
    length = torch.tensor([0, 1, c - 1, c, c + 1, 131, W - 1, W],
                          dtype=torch.int32, device=cuda_device)
    args = (q, ck.transpose(1, 2), cv.transpose(1, 2), length)
    o, m, l = kops.flash_decode(*args)
    _decode_close((o, m, l), kref.decode_attention(*args))
    assert bool((o[0] == 0).all()) and bool((l[0] == 0).all())
    assert bool((m[0] == float("-inf")).all())


def _serving_decode_inputs(dev):
    """The last decode step of chip_smoke.py's deepseek-moe-16b serving:
    q (8, 16, 128) bf16 over a (8, 321, 16, 128) cache, lengths 257-321."""
    rng = np.random.default_rng(15)
    q, ck, cv = _on(dev, rng.normal(size=(8, 16, 128)),
                    rng.normal(size=(8, 321, 16, 128)),
                    rng.normal(size=(8, 321, 16, 128)))
    length = torch.as_tensor(rng.integers(257, 322, 8).astype(np.int32),
                             device=dev)
    return (q.to(torch.bfloat16), ck.to(torch.bfloat16).transpose(1, 2),
            cv.to(torch.bfloat16).transpose(1, 2), length)


def test_flash_decode_kernel_at_serving_shape(cuda_device):
    """The serving shape, 8 x 16 x 6 split blocks: within DECODE_TOL, and
    the same bits on a second call (the merge runs in a fixed order)."""
    args = _serving_decode_inputs(cuda_device)
    got = kops.flash_decode(*args)
    _decode_close(got, kref.decode_attention(*args))
    for x, y in zip(got, kops.flash_decode(*args)):
        same(x, y)


def test_reduced_model_decode_on_cuda_equals_cpu(cuda_device):
    """Reduced deepseek-moe-16b (f32), the same weights on both devices,
    6 teacher-forced decode steps: logits within 1e-4 (f32 products in
    another order; TF32 off) and the same greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("deepseek-moe-16b").reduced()
    cpu = lm.init_lm(cfg, seed=5, device="cpu")
    gpu = lm.init_lm(cfg, seed=5, device="cpu").to(cuda_device)
    rng = np.random.default_rng(5)
    states = [lm.init_decode_state(cfg, 4, 8, device=d)
              for d in ("cpu", cuda_device)]
    for _ in range(6):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, 4).astype(np.int32))
        lc, states[0] = lm.decode_step(cpu, states[0], tok)
        lg, states[1] = lm.decode_step(gpu, states[1], tok.to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        same(lg.argmax(-1), lc.argmax(-1))


RG_LRU_CASES = [(8, 1, 4096, True), (2, 37, 50, True), (3, 300, 200, False),
                (1, 20, 4096, True), (2, 1000, 96, False),
                (5, 100, 1000, True), (1, 77, 33, False), (3, 5, 64, True)]


@pytest.mark.parametrize("B,S,D,given_h0", RG_LRU_CASES)
def test_rg_lru_kernel_matches_plain_version(cuda_device, B, S, D,
                                             given_h0):
    """Bit for bit: S = 1 (decode) and S = 5 (the column kernel); S
    shorter than one ring stage of 32 steps (20), S not a multiple of it
    (37, 77, 100, 300, 1000); D not a multiple of 32 (50, 33: also not of
    4, so 4-byte copies; 200, 1000); B * D / 32 above 132 SMs (5 x 32
    blocks); h0 given or None."""
    rng = np.random.default_rng(S + D)
    a, b, h0 = _on(cuda_device, rng.uniform(0.7, 1.0, (B, S, D)),
                   rng.normal(size=(B, S, D)), rng.normal(size=(B, D)))
    a, b, h0 = a.float(), b.float(), h0.float() if given_h0 else None
    same(kops.rg_lru_scan(a, b, h0), kref.rg_lru_scan(a, b, h0))


FLASH_CASES = [  # B, H, Hkv, S, Skv, d, causal, window
    (2, 4, 4, 64, 64, 16, True, 0),      # g 1, S == Skv
    (1, 8, 2, 100, 130, 64, True, 0),    # g 4, end-aligned S < Skv
    (1, 16, 1, 70, 150, 256, True, 48),  # g 16 (MQA), window, ragged
    (2, 4, 1, 33, 33, 64, False, 0),     # non-causal
    (1, 4, 1, 65, 97, 16, False, 20),    # non-causal window, S < Skv
    (1, 2, 1, 12, 5, 32, True, 0),       # S > Skv: rows without a key
    (1, 16, 16, 130, 130, 128, True, 0),  # d 128 (deepseek-moe-16b), g 1
    (1, 8, 2, 96, 160, 128, True, 40),   # d 128, g 4, window, S < Skv
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,Skv,d,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_version(
        cuda_device, B, H, Hkv, S, Skv, d, causal, window, dtype):
    """q, k and v read through (B, H, S, d) views of (B, S, H, d)
    tensors, as the model passes them, within kernels/ref.py's mha_tol:
    f32 within 2e-5 (scalar f32 sums in another order over up to 256
    terms); bf16 within one rounding step of the output (2**-7 of it)
    plus 2**-8 of its RMS."""
    rng = np.random.default_rng(S * Skv + d)
    q, k, v = _on(cuda_device, rng.normal(size=(B, S, H, d)),
                  rng.normal(size=(B, Skv, Hkv, d)),
                  rng.normal(size=(B, Skv, Hkv, d)))
    q, k, v = (x.to(dtype).transpose(1, 2) for x in (q, k, v))
    got = kops.flash_attention(q, k, v, causal=causal, window=window)
    want = kref.mha(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, H, S, d)
    torch.testing.assert_close(got, want, **kref.mha_tol(want))


def _with_planted_fault(lib: str, old: str, new: str, tmp_path, call):
    """Write csrc/<lib>.cu with `old` replaced by `new` to tmp_path, build
    it and run `call()` with it standing in for the kernel's library."""
    from repro_torch.kernels import _build, _launch
    source = (_build.CSRC / f"{lib}.cu").read_text()
    assert source.count(old) == 1
    faulty = tmp_path / f"faulty_{lib}.cu"
    faulty.write_text(source.replace(old, new))
    with _launch.library(lib, _build.load_file(faulty)):
        return call()


# planted faults of csrc/flash_attention.cu's bf16 kernel: (its text, the
# faulty text)
FLASH_FAULTS = {
    "dropped kv tile": (
        "    const bf16* ks = k_s + (t & 1) * kBK * kRow;\n",
        "    if (t == 1) continue;\n"
        "    const bf16* ks = k_s + (t & 1) * kBK * kRow;\n"),
    "window edge one key off": (
        "*first = window > 0 ? pos - window + 1 : 0;",
        "*first = window > 0 ? pos - window + 2 : 0;"),
}


@pytest.mark.parametrize("fault", sorted(FLASH_FAULTS))
def test_flash_limit_rejects_planted_faults(cuda_device, fault, tmp_path):
    """mha_tol must tell the kernel from one with a planted fault at the
    prefill's headline call (the last query chunk of recurrentgemma-9b's
    last local-attention layer: q (1, 4096, 16, 256), k/v (1, 6143, 1,
    256), bf16, window 2048) on unit-variance inputs. The faulty source
    is written to tmp_path and stands in for the kernel's library during
    this test only."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               .to(cuda_device, torch.bfloat16).transpose(1, 2)
               for shape in ((1, 4096, 16, 256), (1, 6143, 1, 256),
                             (1, 6143, 1, 256)))
    kw = dict(causal=True, window=2048)
    want = kref.mha(q, k, v, **kw)
    tol = kref.mha_tol(want)
    torch.testing.assert_close(kops.flash_attention(q, k, v, **kw), want,
                               **tol)
    got = _with_planted_fault(
        "flash_attention", *FLASH_FAULTS[fault], tmp_path,
        lambda: kops.flash_attention(q, k, v, **kw))
    err = float((got.float() - want.float()).abs().max())
    rms = float(want.float().square().mean().sqrt())
    print(f"{fault}: max abs err {err:.6g}; limit rtol {tol['rtol']:.6g} "
          f"atol {tol['atol']:.6g}; output RMS {rms:.6g}")
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **tol)


# a planted fault of csrc/flash_decode.cu: the merge takes the second
# split's partial without rescaling it to the global max
DECODE_FAULT = (
    "      const float w = isfinite(mi) ? expf(mi - m_use) : 0.f;\n",
    "      const float w = isfinite(mi) ? (i == 1 ? 1.f : expf(mi - m_use))"
    " : 0.f;\n")


def test_decode_limit_rejects_planted_fault(cuda_device, tmp_path):
    """DECODE_TOL must tell the split kernel from one whose merge skips a
    split's rescale, at the serving shape."""
    args = _serving_decode_inputs(cuda_device)
    want = kref.decode_attention(*args)
    _decode_close(kops.flash_decode(*args), want)
    got = _with_planted_fault("flash_decode", *DECODE_FAULT, tmp_path,
                              lambda: kops.flash_decode(*args))
    out = got[0] / got[2].clamp(min=1e-30)[..., None]
    out_r = want[0] / want[2].clamp(min=1e-30)[..., None]
    print(f"merge without a rescale: max |o/l| err "
          f"{float((out - out_r).abs().max()):.6g}")
    with pytest.raises(AssertionError):
        _decode_close(got, want)


def test_reduced_recurrentgemma_on_cuda_equals_cpu(cuda_device):
    """Reduced recurrentgemma-9b (f32, window 32), the same weights on both
    devices, TF32 off: prefill logits at every position of 40 tokens, and
    40 teacher-forced decode steps (the rings wrap), within 1e-4 with the
    same greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("recurrentgemma-9b").reduced()
    cpu = lm.init_lm(cfg, seed=6, device="cpu")
    gpu = lm.init_lm(cfg, seed=6, device="cpu").to(cuda_device)
    rng = np.random.default_rng(6)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    full = [lm.logits_fn(m, cfg, lm._forward(m, cfg, t)) for m, t in
            ((cpu, tok), (gpu, tok.to(cuda_device)))]
    torch.testing.assert_close(full[1].cpu(), full[0], rtol=1e-4, atol=1e-4)
    states = [lm.init_decode_state(cfg, 2, 40, device=d)
              for d in ("cpu", cuda_device)]
    for t in range(40):
        lc, states[0] = lm.decode_step(cpu, states[0], tok[:, t])
        lg, states[1] = lm.decode_step(gpu, states[1],
                                       tok[:, t].to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        same(lg.argmax(-1), lc.argmax(-1))


# ---------------------------------------------------------------------------
# The owner lanes (csrc/owner_lane.cu) on kernels/lane_cases.py's edge
# cases, bit for bit, and three faults planted in the kernel
# ---------------------------------------------------------------------------
LANE_CASES = lane_cases.owner_lane_cases()
_LANE_WANT = {}


def _lane_want(i):
    """The plain version's output on case i, on the CPU (kept)."""
    if i not in _LANE_WANT:
        _, name, args, kw = LANE_CASES[i]
        _LANE_WANT[i] = getattr(kref, name)(*_on("cpu", *args), **kw)
    return _LANE_WANT[i]


def _lane_got(i, dev):
    _, name, args, kw = LANE_CASES[i]
    return [x.cpu() for x in getattr(kops, name)(*_on(dev, *args), **kw)]


@pytest.mark.parametrize("i", range(len(LANE_CASES)), ids=[
    f"{name}: {label}" for label, name, _, _ in LANE_CASES])
def test_owner_lane_kernel_on_edge_case(cuda_device, i):
    for x, y in zip(_lane_got(i, cuda_device), _lane_want(i)):
        same(x, y)


def test_owner_lane_counts_one_launch_a_call(cuda_device):
    """A wrapper call launches a copy and an apply and counts one."""
    from repro_torch.kernels import amo_apply as kamo
    _, _, args, _ = LANE_CASES[0]
    before = kamo.amo_apply.launches
    kops.amo_apply(*_on(cuda_device, *args))
    assert kamo.amo_apply.launches == before + 1


# planted faults of csrc/owner_lane.cu: (its text, the faulty text, the
# edge case aimed at it)
LANE_FAULTS = {
    "within-word order reversed": (
        "    const int src = q;   // list order: the stable sort keeps it "
        "per word\n",
        "    const int src = q < n ? n - 1 - q : q;\n",
        "one word: CAS chain"),
    "overlapping puts first-writer-wins": (
        "      for (int k = 0; k < n; ++k) {   // list order: the last "
        "writer wins\n",
        "      for (int k = n - 1; k >= 0; --k) {\n",
        "fused: overlapping puts, gathers of written words"),
    "last chunk dropped": (
        "  for (int c0 = 0; c0 < r.total; c0 += kChunk) {\n",
        "  for (int c0 = 0; c0 + kChunk < r.total; c0 += kChunk) {\n",
        "live counts at the chunk"),
}


@pytest.mark.parametrize("fault", sorted(LANE_FAULTS))
def test_owner_lane_cases_reject_planted_faults(cuda_device, fault,
                                                tmp_path):
    """With the fault built in, the kernels must differ from their plain
    versions on the edge case aimed at it (every case runs; the ones that
    differ are printed)."""
    old, new, label = LANE_FAULTS[fault]

    def differing():
        return [i for i in range(len(LANE_CASES))
                if not all(torch.equal(x, y) for x, y in
                           zip(_lane_got(i, cuda_device), _lane_want(i)))]
    bad = _with_planted_fault("owner_lane", old, new, tmp_path, differing)
    print(f"{fault}: differs on " + "; ".join(
        f"{LANE_CASES[i][1]}: {LANE_CASES[i][0]}" for i in bad))
    assert label in {LANE_CASES[i][0] for i in bad}


# planted fault of csrc/rg_lru.cu: each stage is walked from the ring slot
# of the stage before it, a stage consumed one step late
RG_LRU_FAULT = (
    "  return static_cast<int>(st % kStages);\n",
    "  return static_cast<int>((st + kStages - 1) % kStages);\n")


def test_rg_lru_cases_reject_planted_fault(cuda_device, tmp_path):
    """With the fault built in, the ring kernel must differ from the plain
    version on the cases it takes (S >= 8)."""
    def differing():
        bad = []
        for B, S, D, given_h0 in RG_LRU_CASES:
            rng = np.random.default_rng(S + D)
            a, b, h0 = _on(cuda_device, rng.uniform(0.7, 1.0, (B, S, D)),
                           rng.normal(size=(B, S, D)),
                           rng.normal(size=(B, D)))
            a, b = a.float(), b.float()
            h0 = h0.float() if given_h0 else None
            if not torch.equal(kops.rg_lru_scan(a, b, h0),
                               kref.rg_lru_scan(a, b, h0)):
                bad.append((B, S, D, given_h0))
        return bad
    bad = _with_planted_fault("rg_lru", *RG_LRU_FAULT, tmp_path, differing)
    print(f"stage consumed one step late: differs on {bad}")
    assert set(bad) == {c for c in RG_LRU_CASES if c[1] >= 8}


# ---------------------------------------------------------------------------
# The RPC insert (csrc/hash_probe.cu) on kernels/lane_cases.py's B4 cases,
# bit for bit, and three faults planted in its grouping
# ---------------------------------------------------------------------------
INSERT_CASES = lane_cases.hash_insert_cases()
_INSERT_WANT = {}


def _insert_want(i):
    """The plain version's output on B4 case i, on the CPU (kept)."""
    if i not in _INSERT_WANT:
        _, _, args, kw = INSERT_CASES[i]
        _INSERT_WANT[i] = kref.hash_insert(*_on("cpu", *args), **kw)
    return _INSERT_WANT[i]


def _insert_got(i, dev):
    _, _, args, kw = INSERT_CASES[i]
    return [x.cpu() for x in kops.hash_insert(*_on(dev, *args), **kw)]


@pytest.mark.parametrize("i", range(len(INSERT_CASES)), ids=[
    label for label, _, _, _ in INSERT_CASES])
def test_hash_insert_kernel_on_edge_case(cuda_device, i):
    for x, y in zip(_insert_got(i, cuda_device), _insert_want(i)):
        same(x, y)


def test_hash_insert_counts_one_launch_a_call(cuda_device):
    """A wrapper call launches a copy and an insert and counts one."""
    from repro_torch.kernels import hash_probe as khp
    _, _, args, kw = INSERT_CASES[0]
    before = khp.hash_insert.launches
    kops.hash_insert(*_on(cuda_device, *args), **kw)
    assert khp.hash_insert.launches == before + 1


# planted faults of csrc/hash_probe.cu's insert: (its text, the faulty
# text, the edge case aimed at it)
INSERT_FAULTS = {
    "component walked in reverse list order": (
        "      for (int e = q; e < end; ++e) {   // list order within the "
        "component\n",
        "      for (int e = end - 1; e >= q; --e) {\n",
        "one start: 600 requests"),
    "ring-wrap merge dropped": (
        "  const bool wrap = ncomp > 1 &&",
        "  const bool wrap = false &&",
        "ring wrap: last and first components merge"),
    "component boundary at gap >= W - 1": (
        "s.sorted[q - 1] >= W);",
        "s.sorted[q - 1] >= W - 1);",
        "components W - 1 and W apart"),
}


@pytest.mark.parametrize("fault", sorted(INSERT_FAULTS))
def test_hash_insert_cases_reject_planted_faults(cuda_device, fault,
                                                 tmp_path):
    """With the fault built in, the kernel must differ from its plain
    version on the edge case aimed at it (every case runs; the ones that
    differ are printed). The last two faults split a component, so its
    parts are walked at once by two threads and race: the aimed case runs
    up to five times."""
    old, new, label = INSERT_FAULTS[fault]
    aimed = next(i for i, c in enumerate(INSERT_CASES) if c[0] == label)

    def differs(i):
        return not all(torch.equal(x, y) for x, y in
                       zip(_insert_got(i, cuda_device), _insert_want(i)))

    def differing():
        bad = [i for i in range(len(INSERT_CASES)) if differs(i)]
        if aimed not in bad and any(differs(aimed) for _ in range(4)):
            bad.append(aimed)
        return bad
    bad = _with_planted_fault("hash_probe", old, new, tmp_path, differing)
    print(f"{fault}: differs on " + "; ".join(INSERT_CASES[i][0]
                                              for i in bad))
    assert aimed in bad


# ---------------------------------------------------------------------------
# The expert dispatch (csrc/moe_dispatch.cu) and the RPC find
# (csrc/hash_probe.cu) on kernels/lane_cases.py's B7 and B3 cases, bit for
# bit, and faults planted in each
# ---------------------------------------------------------------------------
MOE_CASES = lane_cases.moe_dispatch_cases()
FIND_CASES = lane_cases.hash_find_cases()


def _case_differs(case, dev) -> bool:
    """Kernel against plain version, both on the card, on one case."""
    _, name, args, kw = case
    xs = _on(dev, *args)
    return not all(torch.equal(x, y) for x, y in
                   zip(getattr(kops, name)(*xs, **kw),
                       getattr(kref, name)(*xs, **kw)))


@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=[
    label for label, _, _, _ in MOE_CASES])
def test_moe_dispatch_kernel_on_edge_case(cuda_device, i):
    assert not _case_differs(MOE_CASES[i], cuda_device)


@pytest.mark.parametrize("i", range(len(FIND_CASES)), ids=[
    label for label, _, _, _ in FIND_CASES])
def test_hash_find_kernel_on_edge_case(cuda_device, i):
    assert not _case_differs(FIND_CASES[i], cuda_device)


def test_hash_find_unaligned_mask(cuda_device):
    """A mask whose data starts one byte past a 16-byte boundary: the
    kernel takes its scalar loads, bit for bit."""
    _, _, (table, starts, keys, mask), kw = FIND_CASES[-1]
    table, starts, keys = _on(cuda_device, table, starts, keys)
    flat = torch.zeros(mask.size + 1, dtype=torch.bool, device=cuda_device)
    flat[1:] = torch.as_tensor(mask.reshape(-1), device=cuda_device)
    shifted = flat[1:].view(mask.shape)
    assert shifted.data_ptr() % 16 == 1
    for x, y in zip(kops.hash_find(table, starts, keys, shifted, **kw),
                    kref.hash_find(table, starts, keys, shifted, **kw)):
        same(x, y)


def test_moe_dispatch_counts_one_launch_a_call(cuda_device):
    """A call over several tiles launches a count and a rank and counts
    one."""
    from repro_torch.kernels import moe_dispatch as kmd
    _, _, (ids,), kw = MOE_CASES[0]
    before = kmd.moe_dispatch.launches
    kops.moe_dispatch(*_on(cuda_device, ids), **kw)
    assert kmd.moe_dispatch.launches == before + 1


def test_moe_dispatch_work_words_follow_the_kernel_choice(cuda_device):
    """The buffer the wrapper allocates, as csrc/moe_dispatch.cu sizes it:
    the E counts alone where the serial kernel takes the call (up to 6,144
    ids, or past 2,048 experts), else a row of E tile counts a tile of
    2,048 ids, longer tiles past 65,536 counts."""
    from repro_torch.kernels._launch import I32, I64, function
    words = function("moe_dispatch", "repro_moe_dispatch_work_words",
                     (I64, I32))
    assert words(0, 64) == words(48, 64) == words(6144, 64) == 64
    assert words(6145, 64) == 5 * 64
    assert words(196608, 64) == 97 * 64
    assert words(5000, 2049) == 2049
    assert words(65536 + 2048 + 5, 2048) == 18 * 2048   # tiles of 4,096
    assert words(32 * 32768 * 6, 64) == 1025 * 64       # tiles of 6,144


# planted faults: (source, its text, the faulty text, the case aimed at)
DISPATCH_FAULTS = {
    "B7: one tile's base dropped": (
        "moe_dispatch", "      for (int t = r; t < b; t += R)\n",
        "      for (int t = r == 0 ? R : r; t < b; t += R)\n",
        "every id on one expert, ten tiles"),
    "B7: in-warp rank counted with <=": (
        "moe_dispatch",
        "  return __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));\n",
        "  return __popc(peers & ((2u << (threadIdx.x & 31)) - 1u));\n",
        "T = 6145"),
    "B7: negative ids ranked through __match_any_sync": (
        "moe_dispatch",
        "  if (__any_sync(kFull, neg)) return column_peers(id, *col);\n",
        "  if (false) return column_peers(id, *col);\n",
        "ids outside [0, E) at warp and tile edges"),
    "B3: live slot at index 15 of a group skipped": (
        "hash_probe", "    const int live = __popc(bits);\n",
        "    bits &= 0x7fffu;\n    const int live = __popc(bits);\n",
        "live only at index 15 of a group and the row's last"),
}


@pytest.mark.parametrize("fault", sorted(DISPATCH_FAULTS))
def test_dispatch_and_find_cases_reject_planted_faults(cuda_device, fault,
                                                       tmp_path):
    """With the fault built in, the kernel must differ from its plain
    version on the case aimed at it (every case of the kernel runs; the
    ones that differ are printed)."""
    lib, old, new, label = DISPATCH_FAULTS[fault]
    cases = MOE_CASES if lib == "moe_dispatch" else FIND_CASES

    def differing():
        return [c[0] for c in cases if _case_differs(c, cuda_device)]
    bad = _with_planted_fault(lib, old, new, tmp_path, differing)
    print(f"{fault}: differs on " + "; ".join(bad))
    assert label in bad


def test_auto_stream_on_cuda_equals_cpu(cuda_device):
    """The AUTO stream (hashtable.insert / find with no backend argument,
    measure=False) takes the same arms on the card as on the CPU, with
    equal results and an equal final window, bit for bit."""
    from repro_torch.core import costmodel as cm
    arms, res, data = run_port_auto("cpu", cm.H100_SXM)
    arms_g, res_g, data_g = run_port_auto(cuda_device, cm.H100_SXM)
    assert arms_g == arms
    assert len(set(arms)) > 1
    for i, (x, y) in enumerate(zip(res_g, res)):
        same(x, y, f"result {i}")
    same(data_g, data, "final window")


def _pipelined_stream(dev):
    """A depth-2 pipelined stream on `dev`: deferred RPC inserts and finds
    interleaved with eager fused, unfused and AUTO batches, forced in
    reverse order. Returns (outputs, final window, dispatch points, the
    slot-tagged phase log) on the host."""
    from repro_torch.core import adaptive as ad, costmodel as cm
    from repro_torch.core import pipeline as pl, window
    rng = np.random.default_rng(31)
    P, n = 4, 16
    table = ht.make_hashtable(P, 64, 1, device=dev)
    engine = am.AMEngine(P)
    ht.build_am_handlers(table, engine)
    chooser = ad.AdaptiveEngine(P, am_engine=engine, params=cm.H100_SXM)
    pipe = pl.Pipeline(table, depth=2, am_engine=engine)
    keys = rng.choice(2 ** 20, size=(6, P, n), replace=False).astype(
        np.int32) + 1
    arms = (dict(backend="rpc"), dict(backend="rdma"),
            dict(backend="rdma", fused=False), dict(adaptive=chooser),
            dict(backend="rpc"), dict(adaptive=chooser))
    window.drain_phase_log()
    handles = []
    for b, kw in enumerate(arms):
        k = keys[b]
        handles.append(ht.insert_async(pipe, k, (k * 7)[..., None], **kw))
        handles.append(ht.find_async(pipe, keys[max(0, b - 1)], **kw))
    outs = [h.result() for h in reversed(handles)]
    table = pipe.flush()
    log = [(role, info["slot"], info["seq"])
           for role, _, info in window.drain_phase_log()]
    return ([x.cpu() for o in outs for x in o], table.win.data.cpu(),
            engine.dispatch_points, log)


def test_pipelined_stream_on_cuda_equals_cpu(cuda_device):
    """A depth-2 pipelined stream with deferred AM batches, forced in
    reverse: the same outputs, final window, dispatch points and
    slot-tagged phase log on the card as on the CPU."""
    outs, data, points, log = _pipelined_stream("cpu")
    outs_g, data_g, points_g, log_g = _pipelined_stream(cuda_device)
    for i, (x, y) in enumerate(zip(outs_g, outs)):
        same(x, y, f"output {i}")
    same(data_g, data, "final window")
    assert points_g == points and log_g == log and log


def _chaos_stream(dev):
    """Hash-table batches on every arm (AUTO round robin) and queue
    batches on both arms under the mixed schedule of tests/test_faults.py
    (drops, duplicates, delays, owner 1 dead until round 3). Returns the
    outputs and final windows on the host and the plane's stats."""
    from repro_torch.core import adaptive as ad, faults as flt
    rng = np.random.default_rng(32)
    P, n = 4, 16
    plan = flt.FaultPlan(P, seed=303, drop_rate=0.15, dup_rate=0.15,
                         delay_rate=0.20, delay_rounds=2, dead_owners={1: 3})
    table = ht.make_hashtable(P, 64, 2, device=dev)
    chooser = ad.AdaptiveEngine(P, am_engine=am.AMEngine(P),
                                policy="round_robin")
    q = dq.make_queue(P, 1, 256, 2, device=dev)
    qchooser = ad.AdaptiveEngine(P, am_engine=am.AMEngine(P),
                                 policy="round_robin")
    keys = rng.choice(4000, size=(5, P, n), replace=False).astype(np.int32)
    items = rng.integers(0, 99, (4, P, 4, 2)).astype(np.int32)
    outs = []
    with flt.fault_scope(plan):
        for k in keys:
            k = torch.as_tensor(k, device=dev)
            table, ok, pr = chooser.ht_insert(
                table, k, torch.stack([k * 3, k * 5], -1))
            table, found, got = chooser.ht_find(table, k)
            outs += [ok, pr, found, got]
        for it in items:
            q, ok = qchooser.q_push(q, torch.as_tensor(it, device=dev))
            q, got, vals = qchooser.q_pop(q, 4)
            outs += [ok, got, vals]
    return ([x.cpu() for x in outs], table.win.data.cpu(), q.win.data.cpu(),
            plan.stats(), [d.arm for d in chooser.log])


def test_chaos_stream_on_cuda_equals_cpu(cuda_device):
    """A chaos stream through every arm: the card gives the CPU's replies,
    windows, arms and plane statistics (the schedule is drawn on the host
    from the seed, so both devices see the same faults)."""
    res = _chaos_stream("cpu")
    res_g = _chaos_stream(cuda_device)
    for i, (x, y) in enumerate(zip(res_g[0], res[0])):
        same(x, y, f"output {i}")
    same(res_g[1], res[1], "table window")
    same(res_g[2], res[2], "queue window")
    assert res_g[3] == res[3] and res_g[4] == res[4]
    assert res[3]["dropped"] > 0 and res[3]["dup_filtered"] > 0


# ---------------------------------------------------------------------------
# The transactional owner lane (csrc/txn_lane.cu, B9) on kernels/
# lane_cases.py's edge cases, bit for bit, and two planted faults
# ---------------------------------------------------------------------------
TXN_CASES = lane_cases.txn_group_apply_cases()


def _txn_differs(i, dev) -> bool:
    _, _, args, kw = TXN_CASES[i]
    got = kops.txn_group_apply(*_on(dev, *args), **kw)
    want = kref.txn_group_apply(*_on("cpu", *args), **kw)
    return not all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


@pytest.mark.parametrize("i", range(len(TXN_CASES)),
                         ids=[c[0] for c in TXN_CASES])
def test_txn_group_apply_kernel_on_edge_case(cuda_device, i):
    assert not _txn_differs(i, cuda_device)


def test_txn_group_apply_counts_one_launch_a_call(cuda_device):
    """A wrapper call launches a copy and a walk and counts one; a CPU
    tensor takes the plain version and counts nothing."""
    from repro_torch.kernels import txn_lane
    _, _, args, kw = TXN_CASES[0]
    before = txn_lane.txn_group_apply.launches
    kops.txn_group_apply(*_on(cuda_device, *args), **kw)
    kops.txn_group_apply(*_on("cpu", *args), **kw)
    assert txn_lane.txn_group_apply.launches == before + 1


# planted faults of csrc/txn_lane.cu: (its text, the faulty text, the edge
# case aimed at it)
TXN_FAULTS = {
    "run undone in list order": (
        "        for (long long i = nlog - 1; i >= run_start; --i)\n",
        "        for (long long i = run_start; i < nlog; ++i)\n",
        "a failing guard after writes to its word"),
    "undo log kept across runs": (
        "      if (g != prev) run_start = nlog;   // the plain version's "
        "snapshot\n",
        "      if (prev < 0) run_start = nlog;\n",
        "a group split into two runs"),
}


@pytest.mark.parametrize("fault", sorted(TXN_FAULTS))
def test_txn_group_apply_cases_reject_planted_faults(cuda_device, fault,
                                                     tmp_path):
    """With the fault built in, the kernel must differ from its plain
    version on the edge case aimed at it (the cases that differ are
    printed)."""
    old, new, label = TXN_FAULTS[fault]

    def differing():
        return [TXN_CASES[i][0] for i in range(len(TXN_CASES))
                if _txn_differs(i, cuda_device)]
    bad = _with_planted_fault("txn_lane", old, new, tmp_path, differing)
    print(f"{fault}: differs on " + "; ".join(bad))
    assert label in bad


def _cached_stream(dev):
    """A read-heavy cached stream (AUTO with a BucketCache, the fused arm
    forced for finds): zipf-drawn finds of inserted keys between fresh
    inserts. Returns the outputs and window on the host, cache.stats()
    and the Decisions' cached flags."""
    from repro_torch.core import adaptive as ad, cache
    rng = np.random.default_rng(33)
    P, n = 4, 16
    table = ht.make_hashtable(P, 256, 1, device=dev)
    chooser = ad.AdaptiveEngine(P, am_engine=am.AMEngine(P))
    chooser.attach_cache(cache.BucketCache(P, 256, 1, capacity=64))
    keys = rng.choice(2 ** 20, size=(3, P, n), replace=False).astype(
        np.int32) + 1
    outs = []
    for b, k in enumerate(keys):
        chooser.force_arm = ("am", "rdma", "rdma_fused")[b]
        table, ok, _ = chooser.ht_insert(table, k, (k * 3)[..., None])
        chooser.force_arm = "rdma_fused"
        pool = keys[:b + 1].reshape(-1)
        for _ in range(3):
            q = pool[np.minimum(rng.zipf(1.5, (P, n)) - 1,
                                pool.size - 1)].astype(np.int32)
            table, found, got = chooser.ht_find(table, q)
            outs += [found, got]
        outs.append(ok)
    return ([x.cpu() for x in outs], table.win.data.cpu(),
            chooser.cache.stats(), [d.cached for d in chooser.log])


def test_cached_stream_on_cuda_equals_cpu(cuda_device):
    """The card gives the CPU's results, window, cache counters and
    cached decisions for a cached stream."""
    res, res_g = _cached_stream("cpu"), _cached_stream(cuda_device)
    for i, (x, y) in enumerate(zip(res_g[0], res[0])):
        same(x, y, f"output {i}")
    same(res_g[1], res[1], "window")
    assert res_g[2] == res[2] and res_g[3] == res[3]
    assert res[2]["hits"] > 0


def _txn_batches(dev):
    """Two contending txn batches on every arm, one engine an arm, and a
    move: replies, flags, order, counters and windows on the host."""
    from repro_torch.core import txn
    rng = np.random.default_rng(34)
    P, L = 8, 64
    init = rng.integers(-50, 50, (P, L)).astype(np.int32)
    out = []
    for arm in ("rdma", "rdma_fused", "am", "am_pt", "auto"):
        eng = txn.TxnEngine(P, am_engine=am.AMEngine(P))
        win = ht.Window(data=torch.as_tensor(init, device=dev))
        brng = np.random.default_rng(35)
        for _ in range(2):
            t = txn.Txn(P)
            for _ in range(4):
                dst, off = brng.integers(0, P, P), brng.integers(0, 6, P)
                kind = int(brng.integers(0, 4))
                if kind == 0:
                    t.put(dst, off, brng.integers(-9, 9, P))
                elif kind == 1:
                    t.get(dst, off)
                elif kind == 2:
                    t.cas(dst, off, brng.integers(-50, 50, P),
                          brng.integers(-9, 9, P), chain=brng.random() < .3)
                else:
                    t.fao(dst, off, brng.integers(-3, 4, P))
            r = eng.run(win, t, arm=arm)
            win = r.wins["ht"]
            out.append((arm, r.replies, r.committed, r.chain_ok, r.order,
                        r.rounds, r.aborts, r.saved_reads, r.arm,
                        win.data.cpu()))
    table = ht.make_hashtable(P, 64, 1, device=dev)
    k = np.arange(1, 1 + 2 * P, dtype=np.int32).reshape(P, 2)
    table, _, _ = ht.insert_rdma(table, k, (k * 7)[..., None])
    table, moved, vals = ht.move(table, k[:, 0], k[:, 0] + 1000,
                                 txn.TxnEngine(P, am_engine=am.AMEngine(P)))
    out.append(("move", moved, vals, table.win.data.cpu()))
    return out


def test_txn_batches_on_cuda_equal_cpu(cuda_device):
    """Every txn arm (B1 in the one-sided lock phases, B9 in every commit)
    and a move give the CPU's results bit for bit on the card."""
    from repro_torch.kernels import txn_lane
    before = txn_lane.txn_group_apply.launches
    got = _txn_batches(cuda_device)
    assert txn_lane.txn_group_apply.launches > before
    for a, b in zip(got, _txn_batches("cpu")):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, (list, int, str)):
                assert x == y, a[0]
            else:
                same(x, y, a[0])


# ---------------------------------------------------------------------------
# The train path's kernels: B5 with its log-sum-exp, B10 (the attention
# backward) and B11 (the RG-LRU backward), and a reduced train step
# ---------------------------------------------------------------------------
def _bwd_inputs(case, dev, dtype):
    """q, k, v, do of a FLASH_BWD_CASES case as (B, H, S, d) views on
    `dev` in `dtype`, and the plain forward's o and lse."""
    q, k, v, do = (torch.as_tensor(x).to(dev, dtype).transpose(1, 2)
                   for x in lane_cases.flash_bwd_inputs(case))
    causal, window = case[6], case[7]
    o, lse = kref.flash_fwd_lse(q, k, v, causal=causal, window=window)
    return (q, k, v, o, lse, do), dict(causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", lane_cases.FLASH_BWD_CASES)
def test_flash_attention_lse_matches_plain_version(cuda_device, case,
                                                   dtype):
    """B5 with return_lse: the output within mha_tol and each row's
    log-sum-exp within 1e-5 (f32 sums in another order; +inf on rows
    without a key) of ref.flash_fwd_lse."""
    (q, k, v, _, lse_want, _), kw = _bwd_inputs(case, cuda_device, dtype)
    o_want = kref.mha(q, k, v, **kw)
    o, lse = kops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o, o_want, **kref.mha_tol(o_want))
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", lane_cases.FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_plain_version(cuda_device, case,
                                                   dtype):
    """B10 against ref.flash_bwd on the same inputs (q, k, v, o, lse, do
    read through strided views), dq, dk and dv each within
    ref.flash_bwd_tol; and one launch counted a call."""
    from repro_torch.kernels import flash_attention_bwd as kfab
    args, kw = _bwd_inputs(case, cuda_device, dtype)
    before = kfab.flash_attention_bwd.launches
    got = kops.flash_attention_bwd(*args, **kw)
    assert kfab.flash_attention_bwd.launches == before + 1
    for g, w in zip(got, kref.flash_bwd(*args, **kw)):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, **kref.flash_bwd_tol(w))


def test_flash_attention_bwd_takes_unaligned_bf16_views(cuda_device):
    """B10's bf16 kernels copy 16-byte rows: q, k, v and do given as views
    whose base is off 16 bytes (a d-slice of wider rows) and whose strides
    are not multiples of 8 still give ref.flash_bwd's gradients within
    flash_bwd_tol (the wrapper copies such inputs first)."""
    case = (2, 6, 3, 77, 203, 64, True, 0)
    kw = dict(causal=True, window=0)
    q, k, v, do = (torch.as_tensor(np.pad(x, [(0, 0)] * 3 + [(4, 5)])).to(
        cuda_device, torch.bfloat16)[..., 4:4 + 64].transpose(1, 2)
        for x in lane_cases.flash_bwd_inputs(case))
    assert q.data_ptr() % 16 and q.stride(2) % 8
    o, lse = kref.flash_fwd_lse(q, k, v, **kw)
    for g, w in zip(kops.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                    kref.flash_bwd(q, k, v, o, lse, do, **kw)):
        torch.testing.assert_close(g, w, **kref.flash_bwd_tol(w))


@pytest.mark.parametrize("case", lane_cases.RG_LRU_BWD_CASES)
def test_rg_lru_scan_bwd_matches_plain_version(cuda_device, case):
    """B11 bit for bit with ref.rg_lru_scan_bwd: da, db and dh0."""
    a, b, h0, dh = (None if x is None else torch.as_tensor(x).to(
        cuda_device) for x in lane_cases.rg_lru_bwd_inputs(case))
    h = kref.rg_lru_scan(a, b, h0)
    for g, w in zip(kops.rg_lru_scan_bwd(a, h, h0, dh),
                    kref.rg_lru_scan_bwd(a, h, h0, dh)):
        same(g, w)


@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-9b"])
def test_reduced_train_step_on_cuda_equals_cpu(cuda_device, name):
    """One step of make_train_step (accum 2 of 2 x 40 tokens) on reduced
    f32 weights built once and moved, TF32 off: loss and grad norm within
    1e-5, the updated weights within 1e-4 relative and 1e-4 of max(1, each
    leaf's largest magnitude) absolute (the same f32 math summed in other
    orders; AdamW's first step moves each weight by about lr = 1e-3
    whatever its gradient's size, so a gradient of the other sign would
    differ by 2e-3)."""
    import copy
    from repro_torch.launch import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get(name).reduced()
    cpu = lm.init_lm(cfg, seed=7, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 2, 40)).astype(np.int32))
    out = []
    for model in (cpu, gpu):
        init, step = steps.make_train_step(cfg, lr=1e-3, warmup=1,
                                           total_steps=4)
        opt = init(model)
        dev = model.embed.device
        _, _, m = step(model, opt, {"tokens": toks.to(dev)}, 0)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert out[0] == pytest.approx(out[1], rel=1e-5)
    for a, b in zip(cpu.parameters(), gpu.parameters()):
        scale = max(float(a.detach().abs().max()), 1.0)
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-4,
                                   atol=1e-4 * scale)
