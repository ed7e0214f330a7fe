"""Whisper-base — enc-dec audio [arXiv:2212.04356; unverified].

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865. The conv frontend is
a STUB per the assignment: input_specs provides 1500 precomputed frame
embeddings. ADAPTATION (DESIGN.md §4): whisper's decoder context is 448
tokens, so the 4k/32k sequence lengths are capped at 448 on the decoder
side; decode cells run with the (448-deep self + 1500-deep cross) cache;
long_500k skipped.
"""
from .base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    use_bias=True,
    act="gelu",
    glu=False,
    encoder=EncoderConfig(n_layers=6, n_frames=1500, max_target=448),
    frontend="audio_stub",
    shape_cells=("train_4k", "prefill_32k", "decode_32k"),
    notes="conv frontend stubbed; decoder ctx capped at 448; "
          "long_500k skipped",
)
