"""Llama-4 Maverick 400B-A17B — interleaved MoE
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].

48L d_model=5120 40H (GQA kv=8), MoE on every 2nd layer: 128 routed
experts top-1 + 1 shared (expert d_ff=8192), dense layers d_ff=16384.
~400B total / ~17B active. We model the text tower (early-fusion vision
omitted per assignment). Full attention here => long_500k skipped.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192,
                  interleave_step=2, dense_d_ff=16384,
                  router_group_size=4096),
    rope_theta=500_000.0,
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: full attention; text tower only",
)
