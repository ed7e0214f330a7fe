"""Gemma3-27B — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family; unverified].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. Sliding window
1024 on local layers; global layers use rope_theta=1e6. qk-norm; tied
embeddings with sqrt(d) input scaling. Sub-quadratic (5/6 of layers) =>
long_500k RUNS (global-layer KV is sequence-sharded; DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,                 # 10 groups of (5 local + 1 global) + 2 tail
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
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
