"""deepseek-coder-33b [dense GQA, llama-arch] — arXiv:2401.14196; hf tier.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256,
    optimizer="adafactor",
    shapes=std_shapes(train_accum=16),
    skip_shapes=("long_500k",),
)
