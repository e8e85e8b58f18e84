"""Serving path of the model zoo: the decode half of `repro.models.lm` for
the ATTN, MLP and MOE blocks (dense GQA and fine-grained MoE decoders).

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
and logged by `launch/serve.py`. The path's two kernels are
`kops.flash_decode` (the shard-local body of decode attention) and
`kops.moe_dispatch` (the batched FAA ticket of expert dispatch).

Weights live in `nn.Module`s under the JAX package's parameter names and
layouts (`LM`: `embed`, `layers`, `final_norm`; `Attention`, `Mlp`, `Moe`
blocks); the block math is plain functions on tensors, as in JAX. Layers
are held one by one (JAX stacks each pattern position over n_groups). KV
caches are per layer, (B, W, Hkv, hd), and are written in place at
slot = pos, where JAX returns new caches: that keeps one cache in memory.

Not ported yet (each raises NotImplementedError): the LATTN, RGLRU, MLSTM,
SLSTM, CROSS and EATTN blocks, the encdec and vlm families, and the train
and prefill modes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ATTN, MLP, MOE, ArchConfig
from ..core import costmodel
from ..core.types import Backend
from ..kernels import ops as kops

Tensor = torch.Tensor


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A13); the port "
        f"serves decoder-only models of {tuple(BLOCKS)} blocks")


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
    dt = cfg.compute_dtype

    def norm():
        return torch.zeros((D,), dtype=dt, device=device)

    def dense(shape, dtype=dt):
        return _dense(gen, shape, dtype, device)

    if kind == ATTN:
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
    _not_ported(f"block kind {kind!r}")


class Block(nn.Module):
    """One block's weights as parameters under the JAX names (no
    gradients: the port serves)."""

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


class Mlp(Block):
    kind = MLP

    def forward(self, x: Tensor) -> Tensor:
        return mlp_block(self, x, self.cfg)


class Moe(Block):
    kind = MOE

    def forward(self, x: Tensor):
        return moe_block(self, x, self.cfg)


BLOCKS = {ATTN: Attention, MLP: Mlp, MOE: Moe}


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


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless the port serves this config."""
    if cfg.family in ("encdec", "vlm"):
        _not_ported(f"the {cfg.family} family ({cfg.name})")
    for kinds in cfg.layer_pattern():
        for kind in kinds:
            if kind not in BLOCKS:
                _not_ported(f"block kind {kind!r} ({cfg.name})")


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
# Attention (decode)
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
    at slot = pos; pos (B,) current length. Returns (residual delta,
    cache, the decode backend chosen)."""
    if kind != ATTN:
        _not_ported(f"{kind!r} decode")
    B, S, D = x.shape
    assert S == 1
    W = cache["k"].shape[1]
    q, k, v = _attn_qkv(p, x, cfg, pos[:, None])
    _write_slot(cache["k"], pos, k[:, 0])
    _write_slot(cache["v"], pos, v[:, 0])
    backend = _decode_backend(cfg, W, B)
    out = _decode_attn_distributed(q, cache["k"], cache["v"], pos, backend)
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


# ===========================================================================
# FFN blocks
# ===========================================================================
def mlp_block(p: Block, x: Tensor, cfg: ArchConfig, w1="w1", w3="w3",
              w2="w2") -> Tensor:
    """SwiGLU FFN on rms_norm(x) with the block's own `norm` (a MoE's
    shared experts use the MoE's norm, as in JAX)."""
    h = rms_norm(x, p.norm, cfg.norm_eps)
    u = F.silu(h @ getattr(p, w1)) * (h @ getattr(p, w3))
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
    return torch.bmm(F.silu(u) * g, we2)


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


def _apply_layer(layer: Layer, x: Tensor, cache_in, pos: Tensor,
                 backends: Dict[str, Backend]):
    """Apply one layer's blocks (decode) with residual connections. Returns
    (x, cache_out); the backends chosen are recorded in `backends`."""
    cache_out = []
    for kind, block, cache in zip(layer.kinds, layer.blocks, cache_in):
        if kind == ATTN:
            delta, c, backends["decode"] = block(x, cache, pos)
            cache_out.append(c)
        elif kind == MOE:
            delta, backends["moe"] = block(x)
            cache_out.append(None)
        elif kind == MLP:
            delta = block(x)
            cache_out.append(None)
        else:
            _not_ported(f"block kind {kind!r}")
        x = x + delta
    return x, tuple(cache_out)


def _run_stack(model: LM, x: Tensor, mode: str, caches, pos: Tensor):
    """Every layer in order. Returns (x, caches, backends chosen)."""
    if mode != "decode":
        _not_ported(f"the {mode} mode")
    backends: Dict[str, Backend] = {}
    new_caches = []
    for layer, cache in zip(model.layers, caches):
        x, c = _apply_layer(layer, x, cache, pos, backends)
        new_caches.append(c)
    return x, new_caches, backends


def logits_fn(model: LM, cfg: ArchConfig, x: Tensor) -> Tensor:
    """Tied-table logits (B, S, vocab_padded); padded rows set to -1e30."""
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = x @ model.embed.t()
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> Dict:
    """Zero KV caches, one {k, v: (batch, max_len, Hkv, hd)} per attention
    block of each layer (None for FFN blocks), and pos (batch,) int32."""
    check_supported(cfg)
    dt = cfg.compute_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)

    def block_cache(kind):
        if kind != ATTN:
            return None
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

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
    x, caches, backends = _run_stack(model, x, "decode", state["caches"], pos)
    logits = logits_fn(model, cfg, x)[:, 0]
    new_state = dict(state, caches=caches, pos=pos + 1, backends=backends)
    return logits, new_state
