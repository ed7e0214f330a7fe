"""Public model API: build_model(cfg) -> Model.

The JAX package's ``repro.models.model`` in PyTorch. ``Model`` bundles
parameter init, the training loss (differentiable by autograd, with
``cfg.remat``'s group checkpoints), prefill and one-token
decode for any ArchConfig, including the whisper enc-dec special case and
the VLM stub frontend. Vocab is padded to a multiple of 128.

The loss is two parts: ``_loss_stats`` runs the model on the batch's
rows and returns the masked cross-entropy's sum and count and the MoE
layers' batch means; ``loss_fn`` takes them through
``shard_ctx.line_stats`` (on a mesh, each line's rows run apart and the
statistics are reduced over the global batch) and combines them.

``serve_step`` writes the new K/V, latent or recurrent state into the
cache IN PLACE and returns the logits (the JAX package returns a new
cache; the values are the same). Nothing in it reads a tensor on the
host, so a server can capture it as one CUDA graph over a static cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dtypes import as_dtype
from . import attention as attn
from .layers import (
    Init,
    _dense_init,
    dot_f32,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    matmul,
    mlp,
    rmsnorm,
    unembed_sums,
)
from .transformer import (
    _init_shared_block,
    _init_slot,
    decode_hidden,
    forward_hidden,
    init_slot_cache,
    layer_plan,
    moe_aux_total,
)
from .shard_ctx import executor, gather_fsdp, line_stats, replicate
from .tree import tree_leaves, tree_map, tree_stack

Tensor = torch.Tensor


def padded_vocab(v: int) -> int:
    return ((v + 127) // 128) * 128


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def vocab_pad(self) -> int:
        return padded_vocab(self.cfg.vocab_size)

    @property
    def act_dtype(self) -> torch.dtype:
        return as_dtype(self.cfg.act_dtype)

    # ---------------- params -----------------------------------------------
    def init_params(self, generator: Optional[torch.Generator],
                    device=None) -> dict:
        """Parameters drawn from `generator`, on its device (or `device`;
        ``"meta"`` allocates nothing)."""
        device = torch.device(device if device is not None
                              else generator.device)
        init = Init(generator, device)
        cfg = self.cfg
        dtype = cfg.dtype()
        if cfg.encoder is not None:
            return self._whisper_init(init, dtype)
        head, period, n_groups, tail = layer_plan(cfg)
        params: dict = {
            "embed": init_embedding(init, self.vocab_pad, cfg.d_model, dtype),
            "final_norm": init_rmsnorm(init, cfg.d_model, dtype),
        }
        params["head"] = [_init_slot(init, cfg, s, dtype) for s in head]
        if n_groups > 0:
            params["groups"] = tree_stack([
                {f"slot{j}": _init_slot(init, cfg, s, dtype)
                 for j, s in enumerate(period)}
                for _ in range(n_groups)])
        else:
            params["groups"] = {}
        params["tail"] = [_init_slot(init, cfg, s, dtype) for s in tail]
        if cfg.shared_attn_every:
            params["shared"] = _init_shared_block(init, cfg, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = _dense_init(
                init, (cfg.d_model, self.vocab_pad), dtype)
        if cfg.frontend == "vision_stub":
            params["frontend"] = _dense_init(
                init, (cfg.d_model, cfg.d_model), dtype)
        return params

    def params_spec(self) -> Any:
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return self.init_params(None, device="meta")

    def param_count(self, spec=None) -> int:
        spec = spec if spec is not None else self.params_spec()
        return sum(t.numel() for t in tree_leaves(spec))

    # ---------------- embedding / unembedding --------------------------------
    def _embed_tokens(self, params, tokens: Tensor) -> Tensor:
        h = embed(params["embed"], tokens).to(self.act_dtype)
        if self.cfg.scale_embed:
            # sqrt(d_model) rounded to h's dtype first: a float32 factor
            # would widen the residual stream
            h = h * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=h.dtype).item()
        return h

    def _embed_in(self, params, batch):
        cfg = self.cfg
        h = self._embed_tokens(params, batch["tokens"])
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            pe = matmul(batch["patch_embeds"].to(h.dtype),
                        replicate(params["frontend"]))
            h = torch.cat([pe, h], dim=1)
        b, s = h.shape[0], h.shape[1]
        return h, _positions(b, s, h.device)

    def _unembed_table(self, params) -> Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"]
        return params["lm_head"].t()  # (Vpad, D)

    def _logits(self, table: Tensor, h: Tensor) -> Tensor:
        """(B, D) -> (B, vocab) float32 logits. On a bound mesh each model
        slot takes its block of the vocabulary rows and the logits are
        gathered over the model axis (the JAX package's replicated vocab
        dim); a table the model axis does not split is gathered whole."""
        ex = executor()
        if ex is not None:
            if getattr(table, "mdim", None) != 0:
                table = ex.full(table)
            else:
                rows = table.shape[0] // ex.M
                logits = ex.per_slot(
                    lambda m, dev, hs: dot_f32(hs, ex.narrow(
                        table, 0, m * rows, rows, dev).t()),
                    (h,), lambda line: torch.cat(line, dim=-1))
                # every data index gathers its rows' logits (in the
                # replicated mode, the whole batch's)
                ex.count("all_gather", ex.M * logits.numel() * 4 * ex.D,
                         over=ex.M)
                return logits[:, : self.cfg.vocab_size]
        return dot_f32(h, table.t())[:, : self.cfg.vocab_size]

    @staticmethod
    def _gathered(params) -> dict:
        """On a bound mesh: the leaves outside the layer groups gathered
        (the groups gather theirs at use); the identity without."""
        return {k: (v if k in ("groups", "head", "tail", "shared")
                    else gather_fsdp(v)) for k, v in params.items()}

    # ---------------- train loss ----------------------------------------------
    def loss_fn(self, params, batch) -> tuple:
        """(loss, {"nll", "aux"}): the mean next-token NLL plus the MoE
        aux term; ``torch.autograd.grad`` of the loss gives the gradients
        of ``jax.value_and_grad(loss_fn, has_aux=True)``. On a mesh the
        statistics of the lines' rows reduce over the global batch first
        (``shard_ctx.line_stats``)."""
        sums, means = line_stats(self._loss_stats, params, batch)
        nll = sums["tot"] / torch.clamp(sums["cnt"], min=1.0)
        if self.cfg.encoder is not None:
            return nll, {"nll": nll, "aux": torch.zeros(
                (), dtype=torch.float32, device=nll.device)}
        aux = moe_aux_total(self.cfg, means["moe"], nll.device)
        loss = nll + aux
        return loss, {"nll": nll, "aux": aux}

    def _loss_stats(self, params, batch) -> tuple:
        """``({"tot", "cnt"}, {"moe"})`` of a batch's rows: the masked
        cross-entropy's sum and count of kept positions (the text
        positions only, behind a vision stub's patches), and the MoE
        layers' batch means (``forward_hidden``)."""
        cfg = self.cfg
        params = self._gathered(params)
        if cfg.encoder is not None:
            return self._whisper_loss_stats(params, batch)
        h, positions = self._embed_in(params, batch)
        h, moe_stats = forward_hidden(cfg, params, h, positions)
        labels = batch["labels"]
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            h = h[:, -labels.shape[1]:]  # loss on text positions only
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
        tot, cnt = unembed_sums(self._unembed_table(params), h, labels,
                                cfg.loss_chunk, mask)
        return {"tot": tot, "cnt": cnt}, {"moe": moe_stats}

    # ---------------- prefill (forward only) -----------------------------------
    def prefill_fn(self, params, batch) -> Tensor:
        """Forward pass, last-position logits (the inference-prefill cell)."""
        cfg = self.cfg
        params = self._gathered(params)
        if cfg.encoder is not None:
            return self._whisper_prefill(params, batch)
        h, positions = self._embed_in(params, batch)
        h, _ = forward_hidden(cfg, params, h, positions)
        return self._logits(self._unembed_table(params), h[:, -1])

    # ---------------- decode ----------------------------------------------------
    def init_cache(self, batch: int, s_max: int, device="cuda"):
        """The zeroed decode cache for `batch` rows of `s_max` positions."""
        cfg = self.cfg
        dtype = self.act_dtype
        if cfg.encoder is not None:
            return self._whisper_cache(batch, dtype, device)
        head, period, n_groups, tail = layer_plan(cfg)
        cache = {
            "head": [init_slot_cache(cfg, s, batch, s_max, dtype, device)
                     for s in head],
            "tail": [init_slot_cache(cfg, s, batch, s_max, dtype, device)
                     for s in tail],
        }
        if n_groups > 0:
            one = {f"slot{j}": init_slot_cache(cfg, s, batch, s_max, dtype,
                                               device)
                   for j, s in enumerate(period)}
            cache["groups"] = tree_map(
                lambda x: x.new_zeros((n_groups,) + tuple(x.shape)), one)
        else:
            cache["groups"] = {}
        return cache

    def cache_spec(self, batch: int, s_max: int):
        """The cache tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return self.init_cache(batch, s_max, device="meta")

    def serve_step(self, params, cache, tokens: Tensor,
                   positions: Tensor) -> Tensor:
        """One decode step: tokens (B, 1), positions (B,) -> logits (B, V)
        float32; the cache is written in place."""
        cfg = self.cfg
        params = self._gathered(params)
        if cfg.encoder is not None:
            return self._whisper_serve(params, cache, tokens, positions)
        h = self._embed_tokens(params, tokens)
        h = decode_hidden(cfg, params, cache, h, positions)
        return self._logits(self._unembed_table(params), h[:, 0])

    # ======================= whisper (enc-dec) ================================
    def _whisper_init(self, init: Init, dtype) -> dict:
        cfg = self.cfg

        def enc_layer():
            return {
                "norm1": init_rmsnorm(init, cfg.d_model, dtype),
                "attn": attn.init_gqa(init, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim, dtype,
                                      use_bias=cfg.use_bias),
                "norm2": init_rmsnorm(init, cfg.d_model, dtype),
                "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, dtype,
                                glu=cfg.glu, use_bias=cfg.use_bias),
            }

        def dec_layer():
            return {
                "norm1": init_rmsnorm(init, cfg.d_model, dtype),
                "self_attn": attn.init_gqa(init, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype, use_bias=cfg.use_bias),
                "norm_x": init_rmsnorm(init, cfg.d_model, dtype),
                "cross_attn": attn.init_gqa(init, cfg.d_model, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.head_dim,
                                            dtype, use_bias=cfg.use_bias),
                "norm2": init_rmsnorm(init, cfg.d_model, dtype),
                "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, dtype,
                                glu=cfg.glu, use_bias=cfg.use_bias),
            }

        return {
            "embed": init_embedding(init, self.vocab_pad, cfg.d_model, dtype),
            "pos_embed": _dense_init(
                init, (cfg.encoder.max_target, cfg.d_model), dtype,
                scale=0.02),
            "enc": [enc_layer() for _ in range(cfg.encoder.n_layers)],
            "enc_norm": init_rmsnorm(init, cfg.d_model, dtype),
            "dec": [dec_layer() for _ in range(cfg.n_layers)],
            "final_norm": init_rmsnorm(init, cfg.d_model, dtype),
        }

    def _whisper_encode(self, params, enc_embeds: Tensor) -> Tensor:
        cfg = self.cfg
        h = enc_embeds.to(self.act_dtype)
        b, s, _ = h.shape
        pos = _positions(b, s, h.device)
        for lp in params["enc"]:
            hn = rmsnorm(lp["norm1"], h, cfg.norm_eps)
            h = h + attn.attention_train(
                lp["attn"], hn, pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, rope_theta=None,
                causal=False)
            h = h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h, cfg.norm_eps),
                        act=cfg.act, glu=cfg.glu)
        return rmsnorm(params["enc_norm"], h, cfg.norm_eps)

    def _whisper_decode_stack(self, params, h, pos, enc_out, enc_pos):
        cfg = self.cfg
        for lp in params["dec"]:
            hn = rmsnorm(lp["norm1"], h, cfg.norm_eps)
            h = h + attn.attention_train(
                lp["self_attn"], hn, pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, rope_theta=None,
                causal=True)
            hx = rmsnorm(lp["norm_x"], h, cfg.norm_eps)
            h = h + attn.attention_train(
                lp["cross_attn"], hx, pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, rope_theta=None,
                causal=False, x_kv=enc_out, kv_positions=enc_pos)
            h = h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h, cfg.norm_eps),
                        act=cfg.act, glu=cfg.glu)
        return rmsnorm(params["final_norm"], h, cfg.norm_eps)

    def _whisper_hidden(self, params, batch):
        enc_out = self._whisper_encode(params, batch["enc_embeds"])
        b, se, _ = enc_out.shape
        enc_pos = _positions(b, se, enc_out.device)
        tokens = batch["tokens"]
        sd = tokens.shape[1]
        h = embed(params["embed"], tokens).to(enc_out.dtype)
        h = h + replicate(params["pos_embed"])[None, :sd]
        pos = _positions(b, sd, h.device)
        return self._whisper_decode_stack(params, h, pos, enc_out, enc_pos)

    def _whisper_loss_stats(self, params, batch):
        h = self._whisper_hidden(params, batch)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        tot, cnt = unembed_sums(params["embed"]["table"], h,
                                torch.clamp(labels, min=0),
                                self.cfg.loss_chunk, mask)
        return {"tot": tot, "cnt": cnt}, {}

    def _whisper_prefill(self, params, batch):
        h = self._whisper_hidden(params, batch)
        return self._logits(params["embed"]["table"], h[:, -1])

    def _whisper_cache(self, batch: int, dtype, device):
        cfg = self.cfg
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        tmax = cfg.encoder.max_target
        nf = cfg.encoder.n_frames

        def kv(s):
            return {"k": torch.zeros((batch, s, hkv, dh), dtype=dtype,
                                     device=device),
                    "v": torch.zeros((batch, s, hkv, dh), dtype=dtype,
                                     device=device)}

        return {
            "self": [kv(tmax) for _ in range(cfg.n_layers)],
            # cross K/V precomputed from the encoder at prefill
            "cross": [kv(nf) for _ in range(cfg.n_layers)],
        }

    def prepare_cross_cache(self, params, cache, enc_embeds: Tensor):
        """Fill the cross-attention cache from encoder output (prefill), in
        place; returns the cache."""
        cfg = self.cfg
        enc_out = self._whisper_encode(params, enc_embeds)
        for i, lp in enumerate(params["dec"]):
            k = matmul(enc_out, lp["cross_attn"]["wk"])
            v = matmul(enc_out, lp["cross_attn"]["wv"])
            if "bk" in lp["cross_attn"]:
                k = k + lp["cross_attn"]["bk"]
                v = v + lp["cross_attn"]["bv"]
            b, s, _ = k.shape
            cache["cross"][i]["k"].copy_(
                k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))
            cache["cross"][i]["v"].copy_(
                v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))
        return cache

    def _whisper_serve(self, params, cache, tokens, positions):
        cfg = self.cfg
        b = tokens.shape[0]
        h = embed(params["embed"], tokens).to(self.act_dtype)
        pos_emb = replicate(params["pos_embed"])[
            torch.clamp(positions, max=cfg.encoder.max_target - 1).long()]
        h = h + pos_emb[:, None, :]
        scale = 1.0 / np.sqrt(cfg.head_dim)
        for i, lp in enumerate(params["dec"]):
            hn = rmsnorm(lp["norm1"], h, cfg.norm_eps)
            y, _ = attn.attention_decode(
                lp["self_attn"], cache["self"][i], hn, positions,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                d_head=cfg.head_dim, rope_theta=None)
            h = h + y
            # cross attention against the precomputed encoder cache
            hx = rmsnorm(lp["norm_x"], h, cfg.norm_eps)
            ca = replicate(lp["cross_attn"])
            q = matmul(hx, ca["wq"])
            if "bq" in ca:
                q = q + ca["bq"]
            q = q.reshape(b, 1, cfg.n_heads, cfg.head_dim)
            o = attn.cross_decode(q, cache["cross"][i], scale)
            o = matmul(o.reshape(b, 1, cfg.n_heads * cfg.head_dim),
                       ca["wo"])
            if "bo" in ca:
                o = o + ca["bo"]
            h = h + o
            h = h + mlp(lp["mlp"], rmsnorm(lp["norm2"], h, cfg.norm_eps),
                        act=cfg.act, glu=cfg.glu)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return self._logits(params["embed"]["table"], h[:, 0])


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
