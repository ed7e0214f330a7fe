"""xLSTM-1.3B — recurrent (mLSTM matrix memory + sLSTM) [arXiv:2405.04517].

48 blocks, d_model=2048, 4 heads, vocab=50304, d_ff=0 (blocks carry their
own gating projections). 7:1 mLSTM:sLSTM ratio (every 8th block sLSTM).
O(1) decode state => long_500k runs.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    ssm=SSMConfig(slstm_every=8, mlstm_heads=4, chunk=256),
    shape_cells=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    notes="recurrent: constant-size decode state",
)
