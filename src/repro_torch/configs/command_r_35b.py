"""Command-R 35B — dense GQA, parallel attn+MLP block, no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000. Pure full
attention => long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    parallel_block=True,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: pure full attention",
)
