"""Architecture configuration schema.

Every assigned architecture is a frozen ``ArchConfig``; ``reduced()`` derives
the CPU-smoke-test variant (same family/topology, tiny widths). Input shapes
(the 4 assigned shape cells) live in ``SHAPES``. The dry-run's
``input_specs`` is not here yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dtypes import as_dtype


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0           # per-expert hidden size
    capacity_factor: float = 1.25
    router_group_size: int = 4096  # tokens per dispatch group (scan chunk)
    interleave_step: int = 1       # MoE every k-th layer (1 = every layer)
    dense_d_ff: int = 0            # d_ff of the interleaved dense layers
    first_dense: int = 0           # leading dense layers (deepseek-v2: 1)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    slstm_every: int = 0           # xLSTM: every k-th block is sLSTM
    mlstm_heads: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 6
    n_frames: int = 1500           # whisper: encoder positions (stub frontend)
    max_target: int = 448          # whisper: decoder context limit


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # block pattern
    local_global_ratio: int = 0    # gemma3: k local per 1 global (0 = all global)
    sliding_window: int = 1024
    shared_attn_every: int = 0     # zamba2: shared attn block every k slots
    use_bias: bool = False
    parallel_block: bool = False   # command-r: attn & mlp in parallel
    qk_norm: bool = False
    act: str = "silu"              # silu (GLU) | gelu (plain MLP)
    glu: bool = True
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3: different theta on global layers
    tie_embeddings: bool = False
    scale_embed: bool = False       # gemma: h *= sqrt(d_model)
    norm_eps: float = 1e-6
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None  # vision_stub | audio_stub
    n_frontend_tokens: int = 0      # vlm: patch tokens prepended
    # numerics / execution
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512           # xent sequence-chunk (big-vocab safe)
    # which shape cells apply (DESIGN.md §4): e.g. skip long_500k for
    # pure-full-attention archs
    shape_cells: Tuple[str, ...] = (
        "train_4k", "prefill_32k", "decode_32k",
    )
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def dtype(self) -> torch.dtype:
        return as_dtype(self.param_dtype)

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128,
            vocab_size=512,
            sliding_window=8,
            param_dtype="float32",
            act_dtype="float32",
            loss_chunk=16,
            remat=False,
        )
        if self.local_global_ratio:
            kw["local_global_ratio"] = 2
            kw["n_layers"] = 7  # 2 groups of (2 local + 1 global) + 1 tail
        if self.shared_attn_every:
            kw["shared_attn_every"] = 3
            kw["n_layers"] = 6
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, dense_d_ff=128 if self.moe.dense_d_ff else 0,
                router_group_size=64,
                # drop-free at smoke scale so decode (per-token capacity,
                # never drops) matches teacher forcing exactly
                capacity_factor=8.0,
            )
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                  qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
            kw["d_head"] = 0
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, head_dim=8, chunk=16)
        if self.encoder:
            kw["encoder"] = EncoderConfig(n_layers=2, n_frames=24,
                                          max_target=32)
        if self.frontend == "vision_stub":
            kw["n_frontend_tokens"] = 8
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

