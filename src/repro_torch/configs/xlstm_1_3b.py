"""xlstm-1.3b [sLSTM + mLSTM] — arXiv:2405.04517; unverified tier.
48L d_model=2048 4H d_ff=0 vocab=50304. Block ratio mLSTM:sLSTM = 7:1
(the paper's xLSTM[7:1]); group of 8 layers x 6 groups.
Attention-free -> KV-cache data structures inapplicable (DESIGN.md
§Arch-applicability); runs long_500k."""
from .base import ArchConfig, std_shapes, MLSTM, SLSTM

_GROUP = tuple((MLSTM,) for _ in range(7)) + ((SLSTM,),)

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=_GROUP, rnn_width=2048,
    optimizer="adamw",
    shapes=std_shapes(long=True, train_accum=4),
)
