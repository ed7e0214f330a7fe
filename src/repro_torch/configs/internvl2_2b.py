"""InternVL2-2B — VLM: InternViT frontend (STUB) + InternLM2-1.8B backbone
[arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. Per the assignment,
the vision frontend is a stub: input_specs provides precomputed patch
embeddings (256 tokens) that a linear projector maps into the LM. Full
attention backbone => long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    frontend="vision_stub",
    n_frontend_tokens=256,
    rope_theta=1_000_000.0,
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="vision frontend stubbed (patch embeddings as inputs); "
          "long_500k skipped: full attention",
)
