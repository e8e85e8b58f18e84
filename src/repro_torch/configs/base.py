"""Architecture + shape schema shared by models/, configs/, and launch/
(port of `repro.configs.base`, field for field).

Every assigned architecture is an `ArchConfig`; every assigned input shape
is a `ShapeSpec`. `reduced()` produces the family-preserving small config
used by the CPU tests; `compute_dtype` is a torch dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch

# Block kinds understood by models/lm.py.
ATTN, LATTN, MLP, MOE, RGLRU, MLSTM, SLSTM = (
    "attn", "lattn", "mlp", "moe", "rglru", "mlstm", "slstm")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"
    grad_accum: int = 1       # microbatch count (train only)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- hybrid / recurrent ---
    pattern: Tuple[Tuple[str, ...], ...] = ()   # repeating group of layers,
                                                # each layer = tuple of blocks
    local_window: int = 2048
    rnn_width: int = 0
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    # --- vlm (llava) ---
    n_patch_tokens: int = 0
    # --- common ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # --- paper-technique backends (rdma | rpc | auto) ---
    moe_backend: str = "auto"
    embed_backend: str = "rpc"
    decode_backend: str = "auto"
    # --- training ---
    optimizer: str = "adamw"        # adamw | adafactor (low-mem, big archs)
    remat: bool = True
    # --- shapes assigned to this arch ---
    shapes: Tuple[ShapeSpec, ...] = ()
    skip_shapes: Tuple[str, ...] = ()   # rule-skipped cells (documented)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to a multiple of 256 so the vocab
        axis shards evenly; padded logits are masked to -1e30 in the
        argmax path."""
        return -(-self.vocab // 256) * 256

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_pattern(self) -> Tuple[Tuple[str, ...], ...]:
        """Per-layer block tuples for one repeating group."""
        if self.pattern:
            return self.pattern
        mixer_ffn = (ATTN, MOE if self.n_experts else MLP)
        return (mixer_ffn,)

    @property
    def group_size(self) -> int:
        return len(self.layer_pattern())

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by " \
            f"group of {self.group_size}"
        return self.n_layers // self.group_size

    def params_count(self) -> int:
        """Analytical parameter count (embedding tied with logits)."""
        D, F, hd = self.d_model, self.d_ff, self.hd
        H, Hkv = self.n_heads, self.n_kv_heads
        per_layer = {}
        per_layer[ATTN] = D * H * hd + 2 * D * Hkv * hd + H * hd * D + D
        per_layer[LATTN] = per_layer[ATTN]
        per_layer[MLP] = 3 * D * F + D
        per_layer[MOE] = (D * self.n_experts
                          + 3 * self.n_experts * D * self.moe_d_ff
                          + 3 * D * self.moe_d_ff * self.n_shared_experts
                          + (3 * D * F if self.dense_residual else 0) + D)
        R = self.rnn_width or D
        per_layer[RGLRU] = 3 * D * R + R * D + D
        per_layer[MLSTM] = 4 * D * D + 3 * D + D
        per_layer[SLSTM] = 4 * D * R + 4 * R * R + R * D + D
        total = self.vocab * D
        for g in range(self.n_groups):
            for layer in self.layer_pattern():
                for block in layer:
                    total += per_layer[block]
        if self.n_enc_layers:
            # encoder layers + decoder cross-attention
            total += self.n_enc_layers * (per_layer[ATTN] + per_layer[MLP])
            total += self.n_layers * per_layer[ATTN]
        return total

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.params_count()
        dense_like = replace(
            self, n_experts=self.top_k,
            pattern=(), dense_residual=self.dense_residual)
        # count with top_k routed experts instead of all
        D = self.d_model
        full = self.params_count()
        routed_all = 3 * self.n_experts * D * self.moe_d_ff
        routed_active = 3 * self.top_k * D * self.moe_d_ff
        return full - self.n_layers * (routed_all - routed_active)

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        groups = max(1, min(2, self.n_groups))
        kv = min(self.n_kv_heads, 2)
        heads = max(kv * max(1, min(self.n_heads // self.n_kv_heads, 2)), kv)
        return replace(
            self,
            n_layers=groups * self.group_size,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=32 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            local_window=32,
            rnn_width=64 if (self.rnn_width or self.family in
                             ("hybrid", "ssm")) else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patch_tokens=min(self.n_patch_tokens, 8),
            dtype="float32",
            shapes=(ShapeSpec("smoke", seq_len=16, global_batch=2,
                              kind="train"),),
        )


def std_shapes(*, decode: bool = True, long: bool = False,
               train_accum: int = 16) -> Tuple[ShapeSpec, ...]:
    """The assigned LM shape set. `long` only for sub-quadratic archs."""
    shapes = [
        ShapeSpec("train_4k", 4096, 256, "train", grad_accum=train_accum),
        ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ]
    if decode:
        shapes.append(ShapeSpec("decode_32k", 32768, 128, "decode"))
    if long:
        shapes.append(ShapeSpec("long_500k", 524288, 1, "decode"))
    return tuple(shapes)
