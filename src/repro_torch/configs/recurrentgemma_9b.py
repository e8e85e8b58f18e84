"""recurrentgemma-9b [hybrid RG-LRU + local attn 1:2] — arXiv:2402.19427.
38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
Layer pattern: (rec, rec, lattn) x 6 + (rec,) = 19-layer group x 2 = 38
layers with a 26:12 recurrent:attention split (the paper's ~2:1).
Sub-quadratic -> runs long_500k."""
from .base import ArchConfig, ShapeSpec, std_shapes, RGLRU, LATTN, MLP

_GROUP = (((RGLRU, MLP), (RGLRU, MLP), (LATTN, MLP)) * 6
          + ((RGLRU, MLP),))

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    pattern=_GROUP, local_window=2048, rnn_width=4096,
    optimizer="adamw",
    shapes=std_shapes(long=True, train_accum=8),
)
