"""llava-next-34b [VLM, anyres tiling] — hf:llava-hf/llava-v1.6-*; unverified.
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The vision
frontend is a STUB: input_specs() provides 2880 precomputed anyres patch
embeddings (5 tiles x 576) prepended to the text sequence; the anyres
tile table is modeled as a DHashTable lookup in examples/."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, n_patch_tokens=2880,
    optimizer="adafactor",
    shapes=std_shapes(train_accum=16),
    skip_shapes=("long_500k",),
)
