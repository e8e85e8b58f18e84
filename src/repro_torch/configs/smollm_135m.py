"""smollm-135m [dense GQA, llama-arch small] — hf:HuggingFaceTB/SmolLM-135M.
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Also the end-to-end *real training* example arch (examples/train_lm.py)."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152,
    optimizer="adamw",
    shapes=std_shapes(train_accum=2),
    skip_shapes=("long_500k",),
)
