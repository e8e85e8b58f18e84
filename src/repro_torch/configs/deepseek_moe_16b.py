"""deepseek-moe-16b [fine-grained MoE] — arXiv:2401.06066; hf tier.
28L d_model=2048 16H (kv=16) vocab=102400; 2 shared + 64 routed experts,
top-6, expert d_ff=1408. PRIMARY showcase of the paper's technique:
expert dispatch selects between the RPC (token all_to_all) and RDMA
(expert-weight gather) backends via the cost model."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    capacity_factor=1.25,
    moe_backend="auto",
    optimizer="adamw",
    shapes=std_shapes(train_accum=8),
    skip_shapes=("long_500k",),
)
