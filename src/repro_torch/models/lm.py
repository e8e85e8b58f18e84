"""The model zoo's serving, prefill and training paths: `repro.models.lm`
for the ATTN, LATTN, RGLRU, MLP, MOE, MLSTM and SLSTM blocks of
decoder-only models (dense GQA, fine-grained MoE, the RG-LRU hybrid
recurrentgemma and the xLSTM ssm family), in decode mode and in train
mode (the prefill's forward, and `loss_fn` with its gradients).

The paper's technique enters at two irregular-access points, each with a
backend chosen by the cost model exactly as the JAX model chooses it
(DESIGN.md §3):

  * MoE dispatch (ship tokens to experts vs pull expert weights):
    `_moe_backend`;
  * distributed decode attention (combine per-shard stats vs gather the
    KV cache): `_decode_backend`.

On one device every sharding hint of the JAX model is an identity and is
dropped, and both backends of each point compute the same thing; the
choice is still made, returned in the decode state (`state["backends"]`)
and logged by `launch/serve.py`. The path's kernels are
`kops.flash_decode` (the shard-local body of global-attention decode),
`kops.moe_dispatch` (the batched FAA ticket of expert dispatch),
`kops.rg_lru_scan` (the RG-LRU recurrence, in both modes),
`kops.flash_attention` (full-sequence attention; a CPU tensor takes its
plain version, `kernels/ref.py` `mha`), and the xLSTM cells
`kops.mlstm_chunkwise` (the mLSTM over an even S > 1), `kops.mlstm_step`
(one mLSTM step: decode, and each position of an odd S > 1) and
`kops.slstm_scan` (the sLSTM recurrence, in both modes). With grad
enabled, attention, the scan and the xLSTM cells run as autograd
Functions (`FlashTrain`, JAX's flash_train custom_vjp; `RgLruScan`;
`MlstmChunkwise`, `MlstmStep`, `SlstmScan`) whose backwards are the
kernels `kops.flash_attention_bwd`, `kops.rg_lru_scan_bwd`,
`kops.mlstm_chunkwise_bwd`, `kops.mlstm_step_bwd` and
`kops.slstm_scan_bwd` (JAX differentiates its jnp cells); the MoE
block's gradient flows through the torch gathers and scatters around its
integer tickets. With cfg.remat each layer runs under
torch.utils.checkpoint (JAX remats per group: the same values).

Weights live in `nn.Module`s under the JAX package's parameter names and
layouts (`LM`: `embed`, `layers`, `final_norm`; `Attention`,
`LocalAttention`, `Rglru`, `Mlp`, `Moe`, `Mlstm`, `Slstm` blocks); the
block math is plain functions on tensors, as in JAX. Layers are held one
by one (JAX stacks each pattern position over n_groups). KV caches are
per layer, (B, W, Hkv, hd), and are written in place at slot = pos
(pos % W for the local-attention ring), where JAX returns new caches:
that keeps one cache in memory. The RG-LRU state is (B, R) float32 per
layer. An mLSTM layer holds (C (B, H, hd, hd), n (B, H, hd), m (B, H))
float32, which a decode step updates in place (4 MiB of C a sequence at
xlstm-1.3b's hd = 512: one state of 22.6 GB at batch 128 stays in
memory; with grad enabled a step updates a copy); an sLSTM layer holds
(c, n, h, m), each (B, R) float32, replaced each step. Weights are built
with requires_grad False (serving); `set_trainable` turns it on.

Not ported yet (each raises NotImplementedError): the CROSS and EATTN
blocks and the encdec and vlm families.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import (ATTN, LATTN, MLP, MLSTM, MOE, RGLRU, SLSTM,
                            ArchConfig)
from ..core import costmodel
from ..core.types import Backend
from ..kernels import ops as kops

Tensor = torch.Tensor


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A); the port "
        f"serves, prefills and trains decoder-only models of "
        f"{tuple(BLOCKS)} blocks")


# ===========================================================================
# Primitives
# ===========================================================================
def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale)).to(dt)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., S, H, hd); positions (..., S). Half-split rotation."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ===========================================================================
# Parameters: one module per block, under the JAX package's names
# ===========================================================================
def _dense(gen: torch.Generator, shape, dtype, device, scale=None) -> Tensor:
    """Normal(0, std) drawn straight in `dtype` on `device` (no f32 copy
    of a large block), std = fan_in ** -0.5 unless `scale` is given."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    std = scale if scale is not None else fan_in ** -0.5
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def init_block(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device) -> Dict[str, Tensor]:
    """Seeded weights of one block, shapes and names as JAX's init_block."""
    D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    R = cfg.rnn_width or D
    dt = cfg.compute_dtype

    def norm():
        return torch.zeros((D,), dtype=dt, device=device)

    def dense(shape, dtype=dt, scale=None):
        return _dense(gen, shape, dtype, device, scale)

    if kind in (ATTN, LATTN):
        return {"norm": norm(), "wq": dense((D, H * hd)),
                "wk": dense((D, Hkv * hd)), "wv": dense((D, Hkv * hd)),
                "wo": dense((H * hd, D))}
    if kind == MLP:
        return {"norm": norm(), "w1": dense((D, Fd)), "w3": dense((D, Fd)),
                "w2": dense((Fd, D))}
    if kind == MOE:
        E, Fe = cfg.n_experts, cfg.moe_d_ff
        p = {"norm": norm(), "router": dense((D, E), torch.float32),
             "we1": dense((E, D, Fe)), "we3": dense((E, D, Fe)),
             "we2": dense((E, Fe, D))}
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * Fe
            p.update(ws1=dense((D, Fs)), ws3=dense((D, Fs)),
                     ws2=dense((Fs, D)))
        if cfg.dense_residual:
            p.update(wd1=dense((D, Fd)), wd3=dense((D, Fd)),
                     wd2=dense((Fd, D)))
        return p
    if kind == RGLRU:
        return {"norm": norm(), "wx": dense((D, R)), "wg": dense((D, R)),
                "wr": dense((D, R)), "wo": dense((R, D)),
                "a_param": torch.full((R,), 2.0, dtype=torch.float32,
                                      device=device)}
    if kind == MLSTM:
        return {"norm": norm(), "wq": dense((D, H * hd)),
                "wk": dense((D, H * hd)), "wv": dense((D, H * hd)),
                "wi": dense((D, H), scale=0.01),
                "wf": dense((D, H), scale=0.01),
                "wog": dense((D, H * hd)), "wo": dense((H * hd, D))}
    if kind == SLSTM:
        return {"norm": norm(), "wz": dense((D, R)),
                "wi": dense((D, R), scale=0.01),
                "wf": dense((D, R), scale=0.01), "wog": dense((D, R)),
                "rz": dense((R, R)), "wo": dense((R, D))}
    _not_ported(f"block kind {kind!r}")


class Block(nn.Module):
    """One block's weights as parameters under the JAX names (built with
    requires_grad False; see `set_trainable`)."""

    kind = ""

    def __init__(self, cfg: ArchConfig, weights: Dict[str, Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w, requires_grad=False))


class Attention(Block):
    kind = ATTN

    def forward(self, x: Tensor, cache: Dict[str, Tensor], pos: Tensor):
        return attn_block_decode(self, x, self.cfg, self.kind, cache, pos)


class LocalAttention(Attention):
    """Sliding-window attention: ATTN's weights, a ring cache of
    min(local_window, max_len) slots in decode."""
    kind = LATTN


class Rglru(Block):
    kind = RGLRU

    def forward(self, x: Tensor, state: Optional[Tensor]):
        return rglru_block(self, x, self.cfg, state)


class Mlstm(Block):
    kind = MLSTM

    def forward(self, x: Tensor, state):
        return mlstm_block(self, x, self.cfg, state)


class Slstm(Block):
    kind = SLSTM

    def forward(self, x: Tensor, state):
        return slstm_block(self, x, self.cfg, state)


class Mlp(Block):
    kind = MLP

    def forward(self, x: Tensor) -> Tensor:
        return mlp_block(self, x, self.cfg)


class Moe(Block):
    kind = MOE

    def forward(self, x: Tensor):
        return moe_block(self, x, self.cfg)


BLOCKS = {ATTN: Attention, LATTN: LocalAttention, RGLRU: Rglru,
          MLSTM: Mlstm, SLSTM: Slstm, MLP: Mlp, MOE: Moe}


def make_block(cfg: ArchConfig, kind: str, weights: Dict[str, Tensor]
               ) -> Block:
    if kind not in BLOCKS:
        _not_ported(f"block kind {kind!r}")
    return BLOCKS[kind](cfg, weights)


class Layer(nn.Module):
    """One layer: its blocks in order, each added to the residual stream."""

    def __init__(self, kinds: Tuple[str, ...], blocks: List[Block]):
        super().__init__()
        self.kinds = tuple(kinds)
        self.blocks = nn.ModuleList(blocks)


class LM(nn.Module):
    """A decoder-only model: tied embedding table, layers, final norm."""

    def __init__(self, cfg: ArchConfig, embed: Tensor, layers: List[Layer],
                 final_norm: Tensor):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)


def set_trainable(model: LM, on: bool = True) -> LM:
    """Give every parameter requires_grad = `on` (the train step's
    optimizer init turns it on; serving and the prefill run without
    gradients either way)."""
    for p in model.parameters():
        p.requires_grad_(on)
    return model


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless the port serves and prefills this
    config."""
    if cfg.family in ("encdec", "vlm"):
        _not_ported(f"the {cfg.family} family ({cfg.name})")
    for kinds in cfg.layer_pattern():
        for kind in kinds:
            if kind not in BLOCKS:
                _not_ported(f"block kind {kind!r} ({cfg.name})")


def param_leaves(model: LM) -> List[List[nn.Parameter]]:
    """The parameters grouped as the leaves of JAX's init_params tree, in
    jax.tree's flatten order (dict keys sorted: embed, final_norm, then
    each pattern layer's blocks in order, each block's names sorted); a
    leaf is the list of the n_groups parameters it stacks (layer
    g * len(pattern) + i for group g of pattern layer i)."""
    cfg = model.cfg
    n = len(cfg.layer_pattern())
    leaves = [[model.embed], [model.final_norm]]
    for i, kinds in enumerate(cfg.layer_pattern()):
        for b in range(len(kinds)):
            names = sorted(name for name, _ in
                           model.layers[i].blocks[b].named_parameters(
                               recurse=False))
            leaves += [[getattr(model.layers[g * n + i].blocks[b], name)
                        for g in range(cfg.n_groups)] for name in names]
    return leaves


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, ...]]:
    """Block kinds of every layer in order: the pattern, n_groups times
    (layer g * len(pattern) + i is JAX's group g of pattern layer i)."""
    return [kinds for _ in range(cfg.n_groups)
            for kinds in cfg.layer_pattern()]


def init_lm(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """Seeded random weights at the config's widths, drawn block by block
    in the compute dtype from one torch.Generator on `device`."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.compute_dtype
    embed = _dense(gen, (cfg.vocab_padded, cfg.d_model), dt, device,
                   scale=0.02)
    layers = [Layer(kinds, [make_block(cfg, kind,
                                       init_block(cfg, kind, gen, device))
                            for kind in kinds])
              for kinds in layer_kinds(cfg)]
    final_norm = torch.zeros((cfg.d_model,), dtype=dt, device=device)
    return LM(cfg, embed, layers, final_norm)


# ===========================================================================
# Attention: chunked flash forward (train / prefill)
# ===========================================================================
def _chunk_kv(x: Tensor, bk: int, nk: int) -> Tensor:
    """(B, Skv, Hkv, hd) -> (nk, B, bk, Hkv, hd) zero-padded."""
    B, Skv, Hkv, hd = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 0, nk * bk - Skv))
    return xp.reshape(B, nk, bk, Hkv, hd).transpose(0, 1)


def _chunk_mask(j: int, bk: int, S: int, Skv: int, causal: bool,
                window: int, kv_len: Optional[Tensor], device) -> Tensor:
    """Validity mask (B-or-1, S, bk) for kv chunk j; queries end-aligned."""
    kpos = j * bk + torch.arange(bk, device=device)
    qpos = (torch.arange(S, device=device) + (Skv - S))[:, None]
    ok = (kpos < Skv)[None, None, :].expand(1, S, bk)
    if causal:
        ok = ok & (kpos[None, None, :] <= qpos[None])
    if window > 0:
        ok = ok & (kpos[None, None, :] > qpos[None] - window)
    if kv_len is not None:
        ok = ok & (kpos[None, None, :] < kv_len[:, None, None])
    return ok


def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
               kv_len: Optional[Tensor], block_k: int):
    """Running-softmax loop over kv chunks of block_k keys (JAX's scan).
    q (B, S, H, hd); k/v (B, Skv, Hkv, hd). Returns (out (B, S, H, hd) in
    q's dtype, m (B, S, Hkv, g), l (B, S, Hkv, g))."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, S, Hkv, g, hd).float()
    scale = hd ** -0.5
    bk = min(block_k, Skv)
    nk = -(-Skv // bk)
    kc, vc = _chunk_kv(k, bk, nk), _chunk_kv(v, bk, nk)
    acc = torch.zeros((B, S, Hkv, g, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, S, Hkv, g), float("-inf"), device=q.device)
    l = torch.zeros((B, S, Hkv, g), device=q.device)
    for j in range(nk):
        s = torch.einsum("bsked,bckd->bscke", qg, kc[j].float()) * scale
        ok = _chunk_mask(j, bk, S, Skv, causal, window, kv_len, q.device)
        s = torch.where(ok[..., None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(2))
        msafe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - msafe[:, :, None]),
                        0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - msafe), 0.0)
        acc = acc * alpha[..., None] + torch.einsum(
            "bscke,bckd->bsked", p, vc[j].float())
        l = l * alpha + p.sum(2)
        m = m_new
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(B, S, H, hd)
    return out.to(q.dtype), m, l


class FlashTrain(torch.autograd.Function):
    """JAX's flash_train (custom_vjp) on the port's kernels: the forward is
    kops.flash_attention with return_lse (B5), saving q, k, v, o and each
    row's log-sum-exp; the backward is kops.flash_attention_bwd (B10),
    which recomputes the probabilities from them: O(S d) residuals, never
    the S x Skv scores. q (B, S, H, hd); k/v (B, Skv, Hkv, hd), read
    through (B, H, S, hd) views."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kops.flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o, lse,
            do.transpose(1, 2), causal=ctx.causal, window=ctx.window)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def _flash(q: Tensor, k: Tensor, v: Tensor, causal: bool,
           window: int) -> Tensor:
    """JAX's flash_train: kops.flash_attention (the kernel on the card,
    its plain version on the CPU), reading the (B, S, H, hd) activations
    through (B, H, S, hd) views; with grad enabled, through FlashTrain.
    q (B, S, H, hd); k/v (B, Skv, Hkv, hd) -> (B, S, H, hd)."""
    if torch.is_grad_enabled():
        return FlashTrain.apply(q, k, v, causal, window)
    return kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)


def chunked_flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  window: int = 0, kv_len: Optional[Tensor] = None,
                  block_k: int = 1024) -> Tensor:
    """Attention front-end (JAX's, with its default causal-skip split):
    with kv_len, the plain chunked forward; a causal self-attention longer
    than 2 * block_k runs as min(8, S // block_k) query chunks, each over
    keys from the window's lower bound (0 without a window) to its causal
    frontier only (end-aligned S < Skv slices; in the backward autograd
    sums each chunk's k / v slice gradients); anything else is one flash
    call."""
    if kv_len is not None:
        return _flash_fwd(q, k, v, causal, window, kv_len, block_k)[0]
    S, Skv = q.shape[1], k.shape[1]
    if not causal or S != Skv or S <= 2 * block_k:
        return _flash(q, k, v, causal, window)
    n_chunks = min(8, S // block_k)
    bq = -(-S // n_chunks)
    outs = []
    for i in range(n_chunks):
        qlo, qhi = i * bq, min(S, (i + 1) * bq)
        klo = 0 if window <= 0 else max(0, qlo - window + 1)
        outs.append(_flash(q[:, qlo:qhi], k[:, klo:qhi], v[:, klo:qhi],
                           causal, window))
    return torch.cat(outs, dim=1)


# ===========================================================================
# Attention blocks
# ===========================================================================
def _attn_qkv(p: Block, x: Tensor, cfg: ArchConfig, positions: Tensor):
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q = (h @ p.wq).reshape(B, S, H, hd)
    k = (h @ p.wk).reshape(B, S, Hkv, hd)
    v = (h @ p.wv).reshape(B, S, Hkv, hd)
    k = rope(k, positions, cfg.rope_theta)
    q = rope(q, positions, cfg.rope_theta)
    return q, k, v


def attn_block_train(p: Block, x: Tensor, cfg: ArchConfig, kind: str
                     ) -> Tensor:
    """Full-sequence causal attention (train / prefill forward), over the
    last local_window positions for LATTN; returns the residual delta."""
    if kind not in (ATTN, LATTN):
        _not_ported(f"{kind!r} attention")
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _attn_qkv(p, x, cfg, positions)
    window = cfg.local_window if kind == LATTN else 0
    out = chunked_flash(q, k, v, causal=True, window=window)
    return out.reshape(B, S, -1) @ p.wo


def _write_slot(cache: Tensor, slot: Tensor, new: Tensor) -> None:
    """cache[b, slot[b]] = new[b] in place, for rows with 0 <= slot < W
    (JAX's one-hot `where` leaves the other rows as they were)."""
    B, W = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    s = slot.to(torch.int64).clamp(0, W - 1)
    inside = ((slot >= 0) & (slot < W)).view(B, 1, 1)
    cache[rows, s] = torch.where(inside, new.to(cache.dtype), cache[rows, s])


def attn_block_decode(p: Block, x: Tensor, cfg: ArchConfig, kind: str,
                      cache: Dict[str, Tensor], pos: Tensor):
    """One-token decode. cache = {k, v: (B, W, Hkv, hd)}, written in place
    at slot = pos (ATTN) or pos % W (LATTN, a ring of the last W
    positions); pos (B,) current length. Returns (residual delta, cache,
    the decode backend chosen)."""
    if kind not in (ATTN, LATTN):
        _not_ported(f"{kind!r} decode")
    B, S, D = x.shape
    assert S == 1
    W = cache["k"].shape[1]
    q, k, v = _attn_qkv(p, x, cfg, pos[:, None])
    slot = pos % W if kind == LATTN else pos
    _write_slot(cache["k"], slot, k[:, 0])
    _write_slot(cache["v"], slot, v[:, 0])
    backend = _decode_backend(cfg, W, B)
    if kind == LATTN:
        # slot j holds absolute position p_j <= pos with p_j = j (mod W);
        # valid if within the window
        ar = torch.arange(W, device=pos.device)[None]
        pj = pos[:, None] - ((pos[:, None] - ar) % W)
        valid = (pj >= 0) & (pj > pos[:, None] - W) & (pj <= pos[:, None])
        out = _decode_attn_masked(q, cache["k"], cache["v"], valid)
    else:
        out = _decode_attn_distributed(q, cache["k"], cache["v"], pos,
                                       backend)
    y = out.reshape(B, 1, -1) @ p.wo
    return y, cache, backend


def _decode_backend(cfg: ArchConfig, kv_len: int, batch: int) -> Backend:
    if cfg.decode_backend != "auto":
        return Backend(cfg.decode_backend)
    shards = 16  # model-axis width of the JAX package's production mesh
    return costmodel.choose_attention_backend(
        kv_bytes_per_shard=2 * kv_len // shards * cfg.n_kv_heads * cfg.hd * 2,
        q_heads=cfg.n_heads, head_dim=cfg.hd, shards=shards)


def _decode_attn_distributed(q: Tensor, ck: Tensor, cv: Tensor, pos: Tensor,
                             backend: Backend) -> Tensor:
    """Global-attention decode over the cache on one device: what JAX
    computes as `chunked_flash(q, ck, cv, causal=False, kv_len=pos + 1)`.
    The flash partials (o, m, l) of the valid prefix come from
    kops.flash_decode reading the cache in place, then out = o / l: on one
    shard that is the RPC backend's stats combine, and the RDMA backend's
    gathered cache is the same cache. q (B, 1, H, hd); ck/cv
    (B, W, Hkv, hd)."""
    B, _, H, hd = q.shape
    o, m, l = kops.flash_decode(q[:, 0], ck.transpose(1, 2),
                                cv.transpose(1, 2), pos + 1)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_attn_masked(q: Tensor, k: Tensor, v: Tensor, valid: Tensor
                        ) -> Tensor:
    """Ring-buffer decode (plain torch, as in JAX: no kernel). q
    (B, 1, H, hd); k/v (B, W, Hkv, hd); valid (B, W)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.float()) * hd ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    out = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ===========================================================================
# JAX's sigmoid and silu
# ===========================================================================
def _logistic(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


class _Sigmoid(torch.autograd.Function):
    """_logistic forward; backward by the JVP of lax.logistic, g * (s *
    (1 - s)) from the saved output s. Autograd through _logistic itself
    gives NaN where exp(-x) overflows (x <= -89 in f32); this gives 0, as
    JAX and torch.sigmoid do."""

    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def _sigmoid(x: Tensor) -> Tensor:
    """jax.nn.sigmoid as XLA expands it: 1 / (1 + exp(-x)), each op
    rounded in x's dtype, with JAX's gradient. torch.sigmoid rounds once;
    in bfloat16 the two differ by one step on about a quarter of the
    values. Without grad there is no autograd wrapper."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sigmoid.apply(x)
    return _logistic(x)


def _silu(x: Tensor) -> Tensor:
    """jax.nn.silu: x * sigmoid(x), each op rounded in x's dtype (F.silu
    rounds once); its gradient follows through the product."""
    return x * _sigmoid(x)


# ===========================================================================
# RG-LRU block
# ===========================================================================
class RgLruScan(torch.autograd.Function):
    """kops.rg_lru_scan (B8) with kops.rg_lru_scan_bwd (B11) as its
    backward: the gradient JAX gets from autodiff of the scan. a, b
    (B, S, D) float32; h0 (B, D) float32 or None."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = kops.rg_lru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = kops.rg_lru_scan_bwd(a, h, h0, dh)
        return da, db, None if h0 is None else dh0


def rglru_block(p: Block, x: Tensor, cfg: ArchConfig,
                state: Optional[Tensor] = None):
    """RecurrentGemma RG-LRU mixer. state (B, R) float32, or None (train
    mode: h0 = 0). The gates stay in the compute dtype, the recurrence's
    a and b are float32. Returns (residual delta, new state = h at the
    last position)."""
    h = rms_norm(x, p.norm, cfg.norm_eps)
    xr = h @ p.wx
    gate = _sigmoid(h @ p.wg)
    r = _sigmoid(h @ p.wr).float()
    log_a = 8.0 * r * F.logsigmoid(p.a_param)[None, None, :]
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
         * (xr * gate).float())
    if torch.is_grad_enabled():
        hs = RgLruScan.apply(a, b, state)
    else:
        hs = kops.rg_lru_scan(a, b, state)
    return hs.to(x.dtype) @ p.wo, hs[:, -1]


# ===========================================================================
# xLSTM blocks (MLSTM, SLSTM)
# ===========================================================================
def _rnn_state(*shapes, device) -> Tuple[Tensor, ...]:
    """A zero xLSTM state: float32 zeros of each shape, the last (the
    stabilizer m) filled with -1e30, as JAX's."""
    out = [torch.zeros(s, dtype=torch.float32, device=device)
           for s in shapes[:-1]]
    return (*out, torch.full(shapes[-1], -1e30, dtype=torch.float32,
                             device=device))


def _fresh_state(what: str, needs_grad) -> None:
    """MlstmChunkwise and SlstmScan give no gradient to the state they
    start from (loss_fn starts every block from zeros): they refuse one
    that requires grad rather than drop its gradient."""
    if any(needs_grad):
        raise NotImplementedError(
            f"{what}: the gradient of the entering state is not ported "
            f"(ROADMAP C, port-only limits); start from a state that does "
            f"not require grad")


class MlstmChunkwise(torch.autograd.Function):
    """kops.mlstm_chunkwise (B12) with kops.mlstm_chunkwise_bwd (B15) as
    its backward: the gradient of q, k, v and the gate logits i, f that
    JAX gets from autodiff of _mlstm_chunkwise, the stabilizer's included.
    The forward also keeps each position's normalizer q . n. The entering
    state must not require grad (_fresh_state); the final state's
    gradients are taken."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, C0, n0, m0):
        _fresh_state("MlstmChunkwise", ctx.needs_input_grad[5:])
        h, C, n, m, qn = kops.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0,
                                              with_qn=True)
        ctx.save_for_backward(q, k, v, i, f, C0, n0, m0, h, qn)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        grads = kops.mlstm_chunkwise_bwd(*ctx.saved_tensors, dh, dC, dn, dm)
        return (*grads, None, None, None)


class MlstmStep(torch.autograd.Function):
    """One mLSTM step out of place: kops.mlstm_step (B13) on a copy of
    the state, with kops.mlstm_step_bwd (B16) as its backward, which also
    gives the entering state's gradient (the steps of an odd S chain
    through it). Keeps the entering state for the backward, as JAX's scan
    keeps each step's carry."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, C, n, m):
        out = kops.mlstm_step(q, k, v, i, f, C.clone(), n.clone(), m.clone())
        ctx.save_for_backward(q, k, v, i, f, C, n, m)
        return out

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        return kops.mlstm_step_bwd(*ctx.saved_tensors, dh, dC, dn, dm)


class SlstmScan(torch.autograd.Function):
    """kops.slstm_scan (B14) with kops.slstm_scan_bwd (B17) as its
    backward; the forward keeps each step's c, n, m and tanh(z + h rz).
    rz's gradient, sum over (b, t) of h_{t-1}^T dz_t, is one torch.matmul
    on B17's dz (JAX leaves it to XLA's scan backward), in rz's dtype. The
    entering state must not require grad (_fresh_state)."""

    @staticmethod
    def forward(ctx, z, i, f, o, rz, c0, n0, h0, m0):
        _fresh_state("SlstmScan", ctx.needs_input_grad[5:])
        hs, c, n, h, m, kept = kops.slstm_scan(z, i, f, o, rz, c0, n0, h0,
                                               m0, keep=True)
        ctx.save_for_backward(z, i, f, o, rz, c0, n0, h0, m0, hs, kept)
        return hs, c, n, h, m

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        saved = ctx.saved_tensors
        dz, di, df, do = kops.slstm_scan_bwd(*saved, dhs, dc, dn, dh, dm)
        drz = None
        if ctx.needs_input_grad[4]:
            rz, h0, hs = saved[4], saved[7], saved[9]
            R = rz.shape[0]
            hprev = torch.cat((h0[:, None], hs[:, :-1]), dim=1)
            drz = (hprev.reshape(-1, R).t() @ dz.reshape(-1, R)).to(rz.dtype)
        return dz, di, df, do, drz, None, None, None, None


def mlstm_block(p: Block, x: Tensor, cfg: ArchConfig, state=None):
    """xLSTM mLSTM: matrix memory with stabilized exponential gating.
    state = (C (B, H, hd, hd), n (B, H, hd), m (B, H)) float32, or None
    (zeros, m = -1e30). q, k, v and the gate logits are float32 (q scaled
    by hd**-0.5, k by hd**-0.25); the output gate stays in the compute
    dtype. JAX's branches: an even S > 1 runs chunkwise
    (kops.mlstm_chunkwise), S == 1 one step (kops.mlstm_step, which
    updates the given state in place), an odd S > 1 one step a position on
    a copy of the state. With grad enabled the cells are the autograd
    Functions MlstmChunkwise and MlstmStep, which update no state in place.
    Returns (residual delta, new state)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    grad = torch.is_grad_enabled()
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q = (h @ p.wq).reshape(B, S, H, hd).float() * hd ** -0.5
    kk = (h @ p.wk).reshape(B, S, H, hd).float() * hd ** -0.25
    v = (h @ p.wv).reshape(B, S, H, hd).float()
    it = (h @ p.wi).float()                                  # (B, S, H)
    ft = (h @ p.wf).float()
    og = _sigmoid((h @ p.wog).reshape(B, S, H, hd))
    if state is None:
        state = _rnn_state((B, H, hd, hd), (B, H, hd), (B, H),
                           device=x.device)
    if S > 1 and S % 2 == 0:
        cell = MlstmChunkwise.apply if grad else kops.mlstm_chunkwise
        hs, C, n, m = cell(q, kk, v, it, ft, *state)
    else:
        if S > 1 and not grad:
            state = tuple(t.clone() for t in state)
        step = MlstmStep.apply if grad else kops.mlstm_step
        outs = []
        for t in range(S):
            ht, C, n, m = step(q[:, t], kk[:, t], v[:, t], it[:, t],
                               ft[:, t], *state)
            state = (C, n, m)
            outs.append(ht)
        hs = torch.stack(outs, dim=1)                        # (B, S, H, hd)
    y = (og * hs.to(x.dtype)).reshape(B, S, -1) @ p.wo
    return y, (C, n, m)


def slstm_block(p: Block, x: Tensor, cfg: ArchConfig, state=None):
    """xLSTM sLSTM: scalar memory with the recurrent matrix rz. state =
    (c, n, h, m), each (B, R) float32, or None (zeros, m = -1e30). The
    pre-activations and the output gate are float32; rz reaches
    kops.slstm_scan in its own dtype (the plain version casts it to f32,
    as JAX does; the kernel widens each bf16 value exactly). With grad
    enabled the scan is the autograd Function SlstmScan. Returns
    (residual delta, new state)."""
    B, S, D = x.shape
    R = cfg.rnn_width or D
    h = rms_norm(x, p.norm, cfg.norm_eps)
    z_in = (h @ p.wz).float()
    i_in = (h @ p.wi).float()
    f_in = (h @ p.wf).float()
    og = _sigmoid((h @ p.wog).float())
    if state is None:
        state = _rnn_state(*[(B, R)] * 4, device=x.device)
    scan = SlstmScan.apply if torch.is_grad_enabled() else kops.slstm_scan
    hs, c, n, hl, m = scan(z_in, i_in, f_in, og, p.rz, *state)
    return hs.to(x.dtype) @ p.wo, (c, n, hl, m)


# ===========================================================================
# FFN blocks
# ===========================================================================
def mlp_block(p: Block, x: Tensor, cfg: ArchConfig, w1="w1", w3="w3",
              w2="w2") -> Tensor:
    """SwiGLU FFN on rms_norm(x) with the block's own `norm` (a MoE's
    shared experts use the MoE's norm, as in JAX)."""
    h = rms_norm(x, p.norm, cfg.norm_eps)
    u = _silu(h @ getattr(p, w1)) * (h @ getattr(p, w3))
    return u @ getattr(p, w2)


def moe_block(p: Block, x: Tensor, cfg: ArchConfig):
    """Routed experts (+ shared experts, + dense residual). Returns
    (residual delta, the MoE backend chosen)."""
    B, S, D = x.shape
    h = rms_norm(x, p.norm, cfg.norm_eps)
    backend = _moe_backend(cfg, B * S)
    # one device: the RDMA backend pulls nothing and the RPC backend's
    # all_to_all has one participant, so both are the local dispatch
    y = _moe_local(p, h, cfg)
    if cfg.n_shared_experts:
        y = y + mlp_block(p, x, cfg, "ws1", "ws3", "ws2")
    if cfg.dense_residual:
        y = y + mlp_block(p, x, cfg, "wd1", "wd3", "wd2")
    return y, backend


def _moe_backend(cfg: ArchConfig, tokens: int) -> Backend:
    if cfg.moe_backend != "auto":
        return Backend(cfg.moe_backend)
    expert_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
    return costmodel.choose_moe_backend(
        tokens_per_rank=max(tokens // 256, 1), d_model=cfg.d_model,
        expert_bytes_per_rank=expert_bytes)


def _route(h2: Tensor, p: Block, cfg: ArchConfig):
    """h2 (T, D) -> (expert ids (T*k,) int32, weights (T*k,)) in token-major
    order: f32 router logits, top-k, softmax over the k values."""
    logits = h2.float() @ p.router
    w, ids = torch.topk(logits, cfg.top_k, dim=-1)      # (T, k)
    w = torch.softmax(w, dim=-1)
    return ids.reshape(-1).to(torch.int32), w.reshape(-1).to(h2.dtype)


def _capacity(T: int, cfg: ArchConfig) -> int:
    return max(4, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def _expert_ffn(we1: Tensor, we3: Tensor, we2: Tensor, buf: Tensor) -> Tensor:
    """buf (E, C, D) -> (E, C, D) through each expert's SwiGLU."""
    u = torch.bmm(buf, we1)
    g = torch.bmm(buf, we3)
    return torch.bmm(_silu(u) * g, we2)


def _moe_local(p: Block, h: Tensor, cfg: ArchConfig,
               ids: Optional[Tensor] = None,
               w: Optional[Tensor] = None) -> Tensor:
    """Single-device MoE: each (token, choice) takes the FAA ticket of its
    expert (kops.moe_dispatch); tickets below the capacity place the token
    in the (E, cap, D) buffer, the rest are dropped; every expert's FFN
    runs on its rows; each choice gathers its row back (0 where dropped)
    and the k choices of a token are summed with the router weights.
    `ids`/`w` (T*k,) replace the router's choice when given."""
    B, S, D = h.shape
    h2 = h.reshape(-1, D)
    T = h2.shape[0]
    if ids is None:
        ids, w = _route(h2, p, cfg)
    E, k = cfg.n_experts, cfg.top_k
    cap = _capacity(T, cfg)
    counts, pos = kops.moe_dispatch(ids, n_experts=E)
    keep = pos < cap
    slot = torch.where(keep, ids.to(torch.int64) * cap + pos, E * cap)
    buf = h2.new_zeros((E * cap + 1, D))        # the last row takes drops
    buf[slot] = h2.repeat_interleave(k, dim=0)
    out = _expert_ffn(p.we1, p.we3, p.we2, buf[:E * cap].view(E, cap, D))
    picked = out.reshape(E * cap, D)[slot.clamp(max=E * cap - 1)]
    picked = torch.where(keep[:, None], picked, torch.zeros_like(picked))
    y = (picked * w[:, None]).reshape(T, k, D).sum(1)
    return y.reshape(B, S, D)


# ===========================================================================
# Stack and decode
# ===========================================================================
def embed_tokens(model: LM, cfg: ArchConfig, tokens: Tensor) -> Tensor:
    return model.embed[tokens.to(torch.int64)] * cfg.d_model ** 0.5


def _apply_layer(cfg: ArchConfig, layer: Layer, x: Tensor, mode: str,
                 cache_in, pos: Optional[Tensor],
                 backends: Dict[str, Backend]):
    """Apply one layer's blocks with residual connections, in "decode" mode
    (one token, caches and states carried) or "train" mode (the whole
    sequence, no cache). Returns (x, cache_out); the backends chosen are
    recorded in `backends`."""
    decode = mode == "decode"
    cache_out = []
    for kind, block, cache in zip(layer.kinds, layer.blocks, cache_in):
        c = None
        if kind in (ATTN, LATTN):
            if decode:
                delta, c, backends["decode"] = block(x, cache, pos)
            else:
                delta = attn_block_train(block, x, cfg, kind)
        elif kind in (RGLRU, MLSTM, SLSTM):
            delta, st = block(x, cache if decode else None)
            c = st if decode else None
        elif kind == MOE:
            delta, backends["moe"] = block(x)
        elif kind == MLP:
            delta = block(x)
        else:
            _not_ported(f"block kind {kind!r}")
        cache_out.append(c)
        x = x + delta
    return x, tuple(cache_out)


def _run_stack(model: LM, x: Tensor, mode: str, caches=None,
               pos: Optional[Tensor] = None):
    """Every layer in order, in "decode" or "train" mode (caches None in
    train mode). With grad enabled in train mode and cfg.remat, each layer
    runs under torch.utils.checkpoint (non-reentrant): its activations are
    recomputed in the backward, kernels included. Returns (x, caches,
    backends chosen)."""
    if mode not in ("decode", "train"):
        _not_ported(f"the {mode} mode")
    if caches is None:
        caches = [tuple(None for _ in layer.kinds) for layer in model.layers]
    backends: Dict[str, Backend] = {}
    new_caches = []
    remat = (mode == "train" and model.cfg.remat
             and torch.is_grad_enabled())
    for layer, cache in zip(model.layers, caches):
        if remat:
            x, c = checkpoint(_apply_layer, model.cfg, layer, x, mode, cache,
                              pos, backends, use_reentrant=False)
        else:
            x, c = _apply_layer(model.cfg, layer, x, mode, cache, pos,
                                backends)
        new_caches.append(c)
    return x, new_caches, backends


def _body(model: LM, cfg: ArchConfig, tokens: Tensor,
          extra: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """Tokens (B, S) -> final hidden states (B, S, D): the train-mode
    forward of a decoder-only model, differentiable where grad is enabled.
    `extra` feeds the vlm and encdec front ends, which are not ported."""
    if cfg.family in ("encdec", "vlm"):
        _not_ported(f"the {cfg.family} family ({cfg.name})")
    x = embed_tokens(model, cfg, tokens)
    x, _, _ = _run_stack(model, x, "train")
    return x


@torch.no_grad()
def _forward(model: LM, cfg: ArchConfig, tokens: Tensor,
             extra: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """_body without gradients: the prefill's forward."""
    return _body(model, cfg, tokens, extra)


def logits_fn(model: LM, cfg: ArchConfig, x: Tensor) -> Tensor:
    """Tied-table logits (B, S, vocab_padded); padded rows set to -1e30."""
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = x @ model.embed.t()
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


def loss_fn(model: LM, cfg: ArchConfig, batch: Dict[str, Tensor]) -> Tensor:
    """JAX's loss_fn: the mean over the shifted positions of the f32
    log-sum-exp of the logits minus the target's logit, the target being
    the next token (or batch["labels"] shifted). batch["tokens"] (B, S)
    ints. Differentiable where grad is enabled."""
    tokens = batch["tokens"]
    x = _body(model, cfg, tokens, extra=batch)
    logits = logits_fn(model, cfg, x)
    targets = batch.get("labels", tokens)
    lg = logits[:, :-1].float()
    tg = targets[:, 1:].to(torch.int64)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    return (lse - picked).mean()


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Dict:
    """Zero decode state: per layer, one entry per block: {k, v: (batch,
    W, Hkv, hd)} for attention (W = max_len; min(local_window, max_len)
    for the LATTN ring), a (batch, R) float32 state for RGLRU, (C (batch,
    H, hd, hd), n (batch, H, hd), m (batch, H)) float32 for MLSTM and
    (c, n, h, m), each (batch, R) float32, for SLSTM (m = -1e30, the rest
    zeros; JAX's template), None for FFN blocks; and pos (batch,) int32.
    Every tensor is written in place by the decode steps but the sLSTM's,
    which each step replaces."""
    check_supported(cfg)
    dt = cfg.compute_dtype
    R = cfg.rnn_width or cfg.d_model

    def block_cache(kind):
        if kind in (ATTN, LATTN):
            W = max_len if kind == ATTN else min(cfg.local_window, max_len)
            shape = (batch, W, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)}
        if kind == RGLRU:
            return torch.zeros((batch, R), dtype=torch.float32,
                               device=device)
        if kind == MLSTM:
            H, hd = cfg.n_heads, cfg.hd
            return _rnn_state((batch, H, hd, hd), (batch, H, hd), (batch, H),
                              device=device)
        if kind == SLSTM:
            return _rnn_state(*[(batch, R)] * 4, device=device)
        return None

    caches = [tuple(block_cache(kind) for kind in kinds)
              for kinds in layer_kinds(cfg)]
    return {"caches": caches,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def decode_step(model: LM, state: Dict, tokens: Tensor) -> Tuple[Tensor, Dict]:
    """One token for every sequence. tokens (B,) -> (logits (B, V),
    state'); state' shares the caches (updated in place), advances pos and
    holds the backends chosen under "backends"."""
    cfg = model.cfg
    x = embed_tokens(model, cfg, tokens[:, None])
    pos = state["pos"]
    x, caches, backends = _run_stack(model, x, "decode", state["caches"],
                                     pos)
    logits = logits_fn(model, cfg, x)[:, 0]
    new_state = dict(state, caches=caches, pos=pos + 1, backends=backends)
    return logits, new_state
