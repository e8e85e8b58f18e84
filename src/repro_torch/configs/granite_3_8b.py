"""granite-3-8b [dense GQA] — hf:ibm-granite/granite-3.0-2b-base; hf tier.
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155,
    optimizer="adamw",
    shapes=std_shapes(train_accum=8),
    skip_shapes=("long_500k",),   # pure full attention: O(L^2) at 524k
)
