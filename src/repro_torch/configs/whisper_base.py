"""whisper-base [audio enc-dec] — arXiv:2212.04356; unverified tier.
6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865; conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, S, D).
Shapes: seq_len applies to both encoder frames and decoder tokens
(documented deviation: whisper's native ctx is 1500/448)."""
from .base import ArchConfig, std_shapes

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, n_enc_layers=6,
    optimizer="adamw",
    shapes=std_shapes(train_accum=2),
    skip_shapes=("long_500k",),
)
