"""StarCoder2-15B — dense GQA decoder [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; RoPE; biased
projections and plain-GELU MLP per the HF config. Pure full attention =>
long_500k skipped (DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    use_bias=True,
    act="gelu",
    glu=False,
    rope_theta=100_000.0,
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention",
)
