"""arctic-480b [MoE + dense residual] — hf:Snowflake/snowflake-arctic-base.
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; 128 experts top-2
routed in parallel with a dense residual FFN. Largest collective load in
the assigned pool; optimizer=adafactor (f32 Adam moments would not fit a
single v5e pod for 0.5T params)."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    capacity_factor=1.25,
    moe_backend="auto",
    optimizer="adafactor",
    shapes=std_shapes(train_accum=8),
    skip_shapes=("long_500k",),
)
