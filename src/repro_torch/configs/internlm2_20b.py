"""internlm2-20b [dense GQA] — arXiv:2403.17297; hf tier.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544,
    optimizer="adamw",
    shapes=std_shapes(train_accum=8),
    skip_shapes=("long_500k",),
)
