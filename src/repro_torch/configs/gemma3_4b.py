"""Gemma3-4B — dense, 5:1 local:global [hf:google/gemma-3-1b-pt family].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,                 # 5 groups of 6 + 4 tail local
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab_size=262_144,
    local_global_ratio=5,
    sliding_window=1024,
    qk_norm=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    scale_embed=True,
    shape_cells=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    notes="long_500k runs: 5/6 layers sliding-window",
)
