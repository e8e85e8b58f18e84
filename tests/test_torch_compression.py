"""The port's int8 gradient compression (`repro_torch.optim.compression`)
against the JAX package's (`repro.optim.compression`) on the CPU.

Everything is compared bit for bit: the codes, the scales, the
decompressed tensors, the means and the error state. JAX's
`compressed_mean_grads` runs per rank under `jax.vmap(..., axis_name="r")`
(its psum / pmax over the mapped axis), the port's on the ranks as a
leading axis. Inputs are made with numpy from a seed: f32 and bf16 leaves,
sizes that are not a multiple of the 128-value block, an all-zero leaf
(the 1e-30 floor of the scale) and values exactly halfway between two
codes (rounded half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim import compression as tc
from repro_torch.optim import (compress_int8, compressed_mean_grads,
                               decompress_int8)
from torch_parity import npy, torch_one_thread  # noqa: F401

SHAPES = [(64,), (33,), (16, 24), (3, 5, 7), (300,), (2, 128)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype` (bf16
    rounded once, by JAX, and its bits carried across)."""
    _, jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    if td == torch.bfloat16:
        bits = np.asarray(j).view(np.uint16).astype(np.int16)
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def bits(x) -> np.ndarray:
    """A tensor or array as its raw bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


def same_bits(got, want, what=""):
    g, w = bits(got), bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                        w.dtype, g.shape,
                                                        w.shape)
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                  err_msg=what)


def _halfway() -> np.ndarray:
    """A block whose largest magnitude is 127, so its scale is exactly 1:
    every other value sits halfway between two codes."""
    x = np.arange(-62, 63, dtype=np.float32) + 0.5
    return np.concatenate([x, [127.0, -126.5, 0.5]]).astype(np.float32)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * rng.choice([1e-3, 1.0, 50.0],
                                                 shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# compress_int8 / decompress_int8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_decompress_match_jax(shape, dtype):
    j, t = _pair(_inputs(shape, hash(shape) % 1000), dtype)
    jcodes, jscales = jc.compress_int8(j)
    codes, scales = compress_int8(t)
    same_bits(codes, jcodes, "codes")
    same_bits(scales, jscales, "scales")
    want = jc.decompress_int8(jcodes, jscales, shape, j.dtype)
    got = decompress_int8(codes, scales, shape, t.dtype)
    same_bits(got, want, "decompressed")


@pytest.mark.parametrize("case", ["zeros", "halfway", "zero_block"])
def test_compress_edge_cases_match_jax(case):
    """An all-zero leaf (every scale at the 1e-30 floor, codes 0), a block
    of values halfway between codes (half to even: 0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, -2.5 -> -2), and a zero block between live ones."""
    if case == "zeros":
        x = np.zeros((5, 77), np.float32)
    elif case == "halfway":
        x = _halfway()
    else:
        x = _inputs((3 * 128 + 5,), 7)
        x[128:256] = 0.0
    j, t = _pair(x, "float32")
    jcodes, jscales = jc.compress_int8(j)
    codes, scales = compress_int8(t)
    same_bits(codes, jcodes, "codes")
    same_bits(scales, jscales, "scales")
    if case == "zeros":
        assert (scales == np.float32(tc.SCALE_FLOOR)).all()
        assert not codes.any()
    if case == "halfway":
        assert float(scales[0]) == 1.0
        got = codes.reshape(-1)[:x.size].numpy()
        # 0.5, 1.5, 2.5, -1.5, -2.5
        assert list(got[[62, 63, 64, 60, 59]]) == [0, 2, 2, -2, -2], got
    same_bits(decompress_int8(codes, scales, x.shape, torch.float32),
              jc.decompress_int8(jcodes, jscales, x.shape, jnp.float32))


# ---------------------------------------------------------------------------
# compressed_mean_grads: the ranks as a leading axis against JAX's psum
# ---------------------------------------------------------------------------
def _rank_grads(R, seed, dtype):
    """R ranks' gradients of three leaves (one all zero for rank 0 only,
    one with a halfway block), as a JAX dict and the port's dict."""
    rng = np.random.default_rng(seed)
    leaves = {"w": rng.normal(0, 1, (R, 16, 24)),
              "b": rng.normal(0, 0.01, (R, 33)),
              "h": np.stack([_halfway() * (r + 1) for r in range(R)])}
    leaves["b"][0] = 0.0
    jd, td = {}, {}
    for k, v in leaves.items():
        jd[k], td[k] = _pair(v.astype(np.float32), dtype)
    return jd, td


def _jax_mean(grads, error):
    """JAX's compressed_mean_grads on each rank under vmap."""
    if error is None:
        return jax.vmap(lambda g: jc.compressed_mean_grads(g, "r", None),
                        axis_name="r")(grads)
    return jax.vmap(lambda g, e: jc.compressed_mean_grads(g, "r", e),
                    axis_name="r")(grads, error)


@pytest.mark.parametrize("R,dtype", [(4, "float32"), (3, "float32"),
                                     (4, "bfloat16")])
def test_compressed_mean_grads_match_jax(R, dtype):
    """Two steps, the second fed the first's error: the means (in the
    leaf's dtype, the same in every rank's row) and the f32 error state,
    bit for bit. R = 3 divides by a rank count that is not a power of
    two."""
    jerr = terr = None
    for step in range(2):
        jg, tg = _rank_grads(R, 10 * R + step, dtype)
        jmean, jerr = _jax_mean(jg, jerr)
        tmean, terr = compressed_mean_grads(tg, terr)
        assert set(tmean) == set(jmean) == set(terr)
        for k in jg:
            assert tmean[k].shape == tg[k].shape
            assert tmean[k].dtype == tg[k].dtype
            assert terr[k].dtype == torch.float32
            same_bits(tmean[k], jmean[k], f"step {step} mean {k}")
            same_bits(terr[k], jerr[k], f"step {step} error {k}")
            assert (tmean[k] == tmean[k][:1]).all()


def test_compressed_mean_grads_list_and_no_error():
    """A list of leaves with error=None is the dict's result in order, and
    a rank's error is what its decompressed codes missed."""
    _, tg = _rank_grads(4, 5, "float32")
    dmean, derr = compressed_mean_grads(tg)
    lmean, lerr = compressed_mean_grads(list(tg.values()))
    for (k, m), lm, le in zip(dmean.items(), lmean, lerr):
        assert torch.equal(m, lm) and torch.equal(derr[k], le)
    g = tg["w"].float()
    scale = torch.stack([compress_int8(g[r])[1] for r in range(4)]).amax(0)
    codes = torch.clamp(torch.round(
        g.reshape(4, -1, 128) / scale[:, None]), -127, 127)
    back = (codes * scale[:, None]).reshape(g.shape)
    assert torch.equal(derr["w"], g - back)


def test_compressed_mean_grads_nested_tree_matches_jax():
    """A nested tree (a dict holding a list and a dict) comes back in its
    structure, leaf for leaf JAX's, over two steps fed back."""
    jg, tg = _rank_grads(4, 6, "float32")
    ks = list(tg)
    nest = lambda d: {"a": [d[ks[0]], d[ks[1]]], "b": {"c": d[ks[-1]]}}
    jtree, ttree = nest(jg), nest(tg)
    jmean, jerr = _jax_mean(jtree, None)
    tmean, terr = compressed_mean_grads(ttree)
    jmean, jerr = _jax_mean(jtree, jerr)
    tmean, terr = compressed_mean_grads(ttree, terr)
    assert set(tmean) == {"a", "b"} and len(tmean["a"]) == 2
    for path in (("a", 0), ("a", 1), ("b", "c")):
        tm, te, jm, je = (t[path[0]][path[1]]
                          for t in (tmean, terr, jmean, jerr))
        same_bits(tm, jm, f"mean {path}")
        same_bits(te, je, f"error {path}")


# ---------------------------------------------------------------------------
# tests/test_properties.py::test_int8_compression_bounded_error, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64,), (33,), (16, 24), (3, 5, 7)])
def test_int8_compression_bounded_error(shape):
    """The round trip errs by at most half a code step of its block, so by
    at most max|x| / 127 (+1e-6), on 20 seeded inputs of each shape (the
    JAX test draws 20 examples)."""
    for seed in range(20):
        rng = np.random.default_rng(seed * 97 + len(shape))
        x = torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.float32)
        codes, scales = compress_int8(x)
        y = decompress_int8(codes, scales, x.shape, x.dtype)
        blockmax = float(x.abs().max())
        assert float((y - x).abs().max()) <= blockmax / 127.0 + 1e-6
        assert npy(codes).dtype == np.int8
