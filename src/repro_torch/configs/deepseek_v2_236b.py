"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434; hf].

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, rope 64, nope 128,
v 128); MoE: 160 routed experts top-6 + 2 shared, expert d_ff=1536; first
layer dense (d_ff 12288). Full attention => long_500k skipped. MLA latent
cache makes decode_32k HBM-cheap (DESIGN.md §5).
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102_400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  dense_d_ff=12288, first_dense=1, router_group_size=4096),
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="long_500k skipped: full attention (MLA)",
)
