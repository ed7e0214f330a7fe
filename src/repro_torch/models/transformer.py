"""Block assembly: layer plan, forward over groups, decode with a cache.

The JAX package's ``repro.models.transformer`` in PyTorch. Every
architecture is described by a *layer plan*: a periodic pattern of slots
(mixer kind + ffn kind). The period's parameters are stacked along a
leading group axis, ``params["groups"]["slot{j}"]`` with ``n_groups``
rows per leaf, as the JAX package stacks them with ``jax.vmap``; the port
walks that axis in a Python loop where the JAX package scans it.
Remainder layers (gemma3-4b: 34 = 5 * 6 + 4) live in an explicit tail,
special leading layers (deepseek-v2's first dense FFN) in a head.

The cache mirrors the plan: one stacked leaf per slot per group, plus
head/tail entries. Local-attention slots use ring buffers of size
``sliding_window``. ``decode_hidden`` writes every new K/V, latent and
recurrent state into the cache in place.

With ``cfg.remat`` each layer group of the training forward is
rematerialized (``layers.remat``, the JAX package's ``jax.checkpoint`` of
the scan body): only the group's input is kept for the backward, and the
chunk checkpoints of its attention, MoE and scans nest inside.

On a bound mesh ``gather_fsdp`` hands each group its gathered weights
inside the group's checkpoint; the mixers of ``REPLICATED_MIXERS``
compute replicated over the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import Init, init_mlp, init_rmsnorm, mlp, remat, rmsnorm
from .shard_ctx import executor, gather_fsdp, replicate
from .tree import tree_index, tree_map, tree_store

Tensor = torch.Tensor


# ============================ layer plan ========================================
@dataclasses.dataclass(frozen=True)
class Slot:
    mixer: str          # global | local | mla | mamba | mlstm | slstm | shared_attn
    ffn: str            # mlp | moe | dense_big | none
    theta: float = 10_000.0


def layer_plan(cfg: ArchConfig):
    """Returns (head: [Slot], period: [Slot], n_groups, tail: [Slot])."""
    def mixer_for(i: int) -> Slot:
        if cfg.ssm and cfg.shared_attn_every:      # zamba2
            if (i + 1) % cfg.shared_attn_every == 0:
                return Slot("shared_attn", "none")
            return Slot("mamba", "none")
        if cfg.ssm and cfg.ssm.slstm_every:        # xlstm
            if (i + 1) % cfg.ssm.slstm_every == 0:
                return Slot("slstm", "none")
            return Slot("mlstm", "none")
        if cfg.ssm:
            return Slot("mamba", "none")
        if cfg.mla:
            ffn = "moe"
            if cfg.moe and i < cfg.moe.first_dense:
                ffn = "dense_big"
            return Slot("mla", ffn)
        if cfg.moe:                                # llama4: MoE every k-th
            step = cfg.moe.interleave_step
            ffn = "moe" if (i % step == step - 1) else "dense_big"
            return Slot("global", ffn, cfg.rope_theta)
        if cfg.local_global_ratio:                 # gemma3
            period = cfg.local_global_ratio + 1
            if (i + 1) % period == 0:
                return Slot("global", "mlp",
                            cfg.rope_theta_global or cfg.rope_theta)
            return Slot("local", "mlp", cfg.rope_theta)
        return Slot("global", "mlp", cfg.rope_theta)

    slots = [mixer_for(i) for i in range(cfg.n_layers)]
    # head: leading slots that break the periodic pattern
    n_head = cfg.moe.first_dense if (cfg.moe and cfg.moe.first_dense) else 0
    head, rest = slots[:n_head], slots[n_head:]
    # find the period of the remaining pattern
    period_len = 1
    for cand in range(1, min(len(rest), 12) + 1):
        if all(rest[i] == rest[i % cand] for i in range(len(rest))
               if i < (len(rest) // cand) * cand):
            period_len = cand
            break
    n_groups = len(rest) // period_len
    tail = rest[n_groups * period_len:]
    period = rest[:period_len]
    return head, period, n_groups, tail


# ============================ slot params =======================================
def _init_slot(init: Init, cfg: ArchConfig, slot: Slot, dtype) -> dict:
    p: dict = {"norm1": init_rmsnorm(init, cfg.d_model, dtype)}
    if slot.mixer in ("global", "local"):
        p["attn"] = attn.init_gqa(init, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim, dtype,
                                  use_bias=cfg.use_bias)
    elif slot.mixer == "mla":
        p["attn"] = attn.init_mla(init, cfg.d_model, cfg.n_heads, cfg.mla,
                                  dtype)
    elif slot.mixer == "mamba":
        p["mamba"] = ssm.init_mamba2(init, cfg.d_model, cfg.ssm, dtype)
    elif slot.mixer == "mlstm":
        p["mlstm"] = ssm.init_mlstm(init, cfg.d_model, cfg.ssm.mlstm_heads,
                                    dtype)
    elif slot.mixer == "slstm":
        p["slstm"] = ssm.init_slstm(init, cfg.d_model, cfg.ssm.mlstm_heads,
                                    dtype)
    # shared_attn: weights live in params["shared"], reused at every slot
    if slot.ffn != "none" and slot.mixer != "shared_attn":
        p["norm2"] = init_rmsnorm(init, cfg.d_model, dtype)
        if slot.ffn == "mlp":
            p["mlp"] = init_mlp(init, cfg.d_model, cfg.d_ff, dtype,
                                glu=cfg.glu, use_bias=cfg.use_bias)
        elif slot.ffn == "dense_big":
            dff = cfg.moe.dense_d_ff if cfg.moe else cfg.d_ff
            p["mlp"] = init_mlp(init, cfg.d_model, dff, dtype, glu=cfg.glu,
                                use_bias=cfg.use_bias)
        elif slot.ffn == "moe":
            p["moe"] = moe_mod.init_moe(init, cfg.d_model, cfg.moe, dtype)
    return p


def _init_shared_block(init: Init, cfg: ArchConfig, dtype) -> dict:
    """zamba2: one transformer block reused at every shared_attn slot."""
    return {
        "norm1": init_rmsnorm(init, cfg.d_model, dtype),
        "attn": attn.init_gqa(init, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, dtype),
        "norm2": init_rmsnorm(init, cfg.d_model, dtype),
        "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, dtype, glu=cfg.glu,
                        use_bias=False),
    }


# ============================ train-path blocks ==================================
# mixers that compute replicated over the model axis of a bound mesh: their
# weights' model blocks are gathered whole (ROADMAP.md, divergences)
REPLICATED_MIXERS = ("mla", "mamba", "mlstm", "slstm")


def _shared_block(cfg: ArchConfig, shared: dict, h: Tensor,
                  y: Tensor) -> Tensor:
    """zamba2's shared block after its attention output `y`: the MLP on
    the block's own pre-norm of ``h + y``."""
    return y + mlp(shared["mlp"], rmsnorm(shared["norm2"], h + y),
                   act=cfg.act, glu=cfg.glu)


def _mixer_train(cfg: ArchConfig, slot: Slot, p: dict, shared: Optional[dict],
                 h: Tensor, positions: Tensor) -> Tensor:
    if slot.mixer in REPLICATED_MIXERS:
        p = replicate(p)     # no tensor-parallel form on a mesh
    if slot.mixer in ("global", "local"):
        window = cfg.sliding_window if slot.mixer == "local" else None
        return attn.attention_train(
            p["attn"], h, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=slot.theta, window=window,
            use_qk_norm=cfg.qk_norm)
    if slot.mixer == "mla":
        return attn.mla_train(p["attn"], h, positions, n_heads=cfg.n_heads,
                              mla=cfg.mla)
    if slot.mixer == "mamba":
        return ssm.mamba2_train(p["mamba"], h, cfg.ssm, cfg.d_model)
    if slot.mixer == "mlstm":
        return ssm.mlstm_train(p["mlstm"], h, cfg.ssm.mlstm_heads,
                               cfg.ssm.chunk)
    if slot.mixer == "slstm":
        return ssm.slstm_train(p["slstm"], h, cfg.ssm.mlstm_heads)
    if slot.mixer == "shared_attn":
        y = attn.attention_train(
            shared["attn"], rmsnorm(shared["norm1"], h), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=cfg.rope_theta, use_qk_norm=cfg.qk_norm)
        return _shared_block(cfg, shared, h, y)
    raise ValueError(slot.mixer)


def _slot_train(cfg: ArchConfig, slot: Slot, p: dict, shared, h, positions,
                stats: tuple):
    """One layer: (h, stats), the MoE layer's statistics
    (``moe.moe_stats_apply``) appended to `stats`."""
    if slot.mixer == "shared_attn":
        # zamba2 shared block handles its own norms/residual internally
        return h + _mixer_train(cfg, slot, p, shared, h, positions), stats
    hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
    mix = _mixer_train(cfg, slot, p, shared, hn, positions)
    if cfg.parallel_block and slot.ffn != "none":
        ff = mlp(p["mlp"], hn, act=cfg.act, glu=cfg.glu)
        return h + mix + ff, stats
    h = h + mix
    if slot.ffn == "none":
        return h, stats
    hn2 = rmsnorm(p["norm2"], h, cfg.norm_eps)
    if slot.ffn == "moe":
        ff, st = moe_mod.moe_stats_apply(p["moe"], hn2, cfg.moe)
        stats = stats + (st,)
    else:
        ff = mlp(p["mlp"], hn2, act=cfg.act, glu=cfg.glu)
    return h + ff, stats


def forward_hidden(cfg: ArchConfig, params: dict, h: Tensor,
                   positions: Tensor) -> tuple:
    """Run all layers on embedded input h. Returns (h, moe_stats): the MoE
    layers' statistics in layer order, for ``moe_aux_total``."""
    head, period, n_groups, tail = layer_plan(cfg)
    shared = params.get("shared")
    shared = gather_fsdp(shared) if shared is not None else None
    stats = ()
    for i, slot in enumerate(head):
        h, stats = _slot_train(cfg, slot, gather_fsdp(params["head"][i]),
                               shared, h, positions, stats)

    def group_body(gp, hh):
        gp = gather_fsdp(gp)
        st = ()
        for j, slot in enumerate(period):
            hh, st = _slot_train(cfg, slot, gp[f"slot{j}"], shared, hh,
                                 positions, st)
        return hh, st

    for gp in group_rows(params["groups"], n_groups):
        if cfg.remat:
            h, st = remat(group_body, gp, h)
        else:
            h, st = group_body(gp, h)
        stats = stats + tuple(st)
    for i, slot in enumerate(tail):
        h, stats = _slot_train(cfg, slot, gather_fsdp(params["tail"][i]),
                               shared, h, positions, stats)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), stats


def moe_aux_total(cfg: ArchConfig, stats, device) -> Tensor:
    """The MoE aux loss summed over the layers, in layer order, from
    ``forward_hidden``'s statistics (0 without MoE layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for st in stats:
        aux = aux + moe_mod.moe_aux(st, cfg.moe)
    return aux


def group_rows(groups, n_groups: int) -> list:
    """One tree per layer group: row g of every stacked leaf (views). The
    backward of ``x[g]`` gives each group's gradient as a zeroed tensor
    of the whole stacked leaf; on gemma3-4b at full width that costs no
    peak memory and no time that shows against ``unbind``'s rows
    (``chip_smoke.py`` phase 10 measures both)."""
    return [tree_index(groups, g) for g in range(n_groups)]


# ============================ decode-path blocks ==================================
def init_slot_cache(cfg: ArchConfig, slot: Slot, batch: int, s_max: int,
                    dtype, device):
    """The zeroed cache of one slot."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if slot.mixer == "local":
        w = min(cfg.sliding_window, s_max)
        return {"k": zeros((batch, w, hkv, dh)),
                "v": zeros((batch, w, hkv, dh))}
    if slot.mixer in ("global", "shared_attn"):
        return {"k": zeros((batch, s_max, hkv, dh)),
                "v": zeros((batch, s_max, hkv, dh))}
    if slot.mixer == "mla":
        return {"ckv": zeros((batch, s_max, cfg.mla.kv_lora_rank)),
                "kpe": zeros((batch, s_max, cfg.mla.qk_rope_dim))}
    if slot.mixer == "mamba":
        return zeros(ssm.mamba2_state_shape(batch, cfg.d_model, cfg.ssm),
                     torch.float32)
    if slot.mixer == "mlstm":
        return tuple(zeros(s, torch.float32) for s in
                     ssm.mlstm_state_shape(batch, cfg.d_model,
                                           cfg.ssm.mlstm_heads))
    if slot.mixer == "slstm":
        return tuple(zeros(s, torch.float32) for s in
                     ssm.slstm_state_shape(batch, cfg.d_model,
                                           cfg.ssm.mlstm_heads))
    raise ValueError(slot.mixer)


def _mixer_decode(cfg: ArchConfig, slot: Slot, p: dict, shared, cache,
                  h: Tensor, positions: Tensor):
    ex = executor()
    if ex is not None and slot.mixer in REPLICATED_MIXERS:
        # no tensor-parallel form: the weights gathered whole, and a
        # recurrent state too (written back into its blocks by
        # ``_slot_decode``)
        p = replicate(p)
        if slot.mixer != "mla":
            cache = tree_map(ex.gather_leaf, cache)
    if slot.mixer in ("global", "local"):
        window = cfg.sliding_window if slot.mixer == "local" else None
        return attn.attention_decode(
            p["attn"], cache, h, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, rope_theta=slot.theta,
            window=window, use_qk_norm=cfg.qk_norm)
    if slot.mixer == "mla":
        return attn.mla_decode(p["attn"], cache, h, positions,
                               n_heads=cfg.n_heads, mla=cfg.mla)
    if slot.mixer == "mamba":
        return ssm.mamba2_decode(p["mamba"], cache, h, cfg.ssm, cfg.d_model)
    if slot.mixer == "mlstm":
        return ssm.mlstm_decode(p["mlstm"], cache, h, cfg.ssm.mlstm_heads)
    if slot.mixer == "slstm":
        return ssm.slstm_decode(p["slstm"], cache, h, cfg.ssm.mlstm_heads)
    if slot.mixer == "shared_attn":
        y, cache = attn.attention_decode(
            shared["attn"], cache, rmsnorm(shared["norm1"], h), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            rope_theta=cfg.rope_theta, use_qk_norm=cfg.qk_norm)
        return _shared_block(cfg, shared, h, y), cache
    raise ValueError(slot.mixer)


def _slot_decode(cfg: ArchConfig, slot: Slot, p: dict, shared, cache, h,
                 positions) -> Tensor:
    """One layer of one decode step; its cache is updated in place."""
    ex = executor()
    store = tree_store if ex is None else ex.store_tree
    if slot.mixer == "shared_attn":
        y, new = _mixer_decode(cfg, slot, p, shared, cache, h, positions)
        store(cache, new)
        return h + y
    hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
    mix, new = _mixer_decode(cfg, slot, p, shared, cache, hn, positions)
    store(cache, new)
    if cfg.parallel_block and slot.ffn != "none":
        return h + mix + mlp(p["mlp"], hn, act=cfg.act, glu=cfg.glu)
    h = h + mix
    if slot.ffn == "none":
        return h
    hn2 = rmsnorm(p["norm2"], h, cfg.norm_eps)
    if slot.ffn == "moe":
        ff, _ = moe_mod.moe_apply(p["moe"], hn2, cfg.moe)
    else:
        ff = mlp(p["mlp"], hn2, act=cfg.act, glu=cfg.glu)
    return h + ff


def decode_hidden(cfg: ArchConfig, params: dict, cache: dict, h: Tensor,
                  positions: Tensor) -> Tensor:
    """All layers of one decode step on embedded h (B, 1, D); every slot's
    cache is written in place. Returns the final-normed hidden state."""
    head, period, n_groups, tail = layer_plan(cfg)
    shared = params.get("shared")
    shared = gather_fsdp(shared) if shared is not None else None
    for i, slot in enumerate(head):
        h = _slot_decode(cfg, slot, gather_fsdp(params["head"][i]), shared,
                         cache["head"][i], h, positions)
    for g in range(n_groups):
        gp = gather_fsdp(tree_index(params["groups"], g))
        gc = tree_index(cache["groups"], g)
        for j, slot in enumerate(period):
            h = _slot_decode(cfg, slot, gp[f"slot{j}"], shared,
                             gc[f"slot{j}"], h, positions)
    for i, slot in enumerate(tail):
        h = _slot_decode(cfg, slot, gather_fsdp(params["tail"][i]), shared,
                         cache["tail"][i], h, positions)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)
