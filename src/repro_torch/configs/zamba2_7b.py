"""Zamba2-7B — hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

81 layer-slots, d_model=3584, ssm_state=64; every 3rd slot applies the
SHARED attention+MLP block (one set of weights reused — Zamba's signature
parameter sharing; we use a 2:1 mamba:shared pattern, see DESIGN.md §6),
32H (kv 32), shared-block d_ff=14336. O(1) mamba state + ring-buffer
shared-attn cache => long_500k runs.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk=256),
    shared_attn_every=3,
    shape_cells=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    notes="hybrid: mamba2 + shared attention block (weights reused)",
)
