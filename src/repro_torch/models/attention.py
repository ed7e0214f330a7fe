"""Attention variants: GQA (full / sliding-window banded), MLA, cross.

The JAX package's ``repro.models.attention`` in PyTorch. The training
path is query-chunked: scores for one (B, H, Cq, K) tile at a time, so
the (S x S) score matrix is never materialized; static sliding windows
take the banded path that reads only the (window + Cq) key slice of a
chunk. Scores and softmax are float32; GQA groups the query heads as
(B, Q, Hkv, rep, Dh), and masked scores take ``NEG_INF``.

The decode path scores one new token against the cache and writes the
new K/V (or MLA latent) into the cache IN PLACE, at a slot computed on
the device: local layers keep a ring buffer of ``window`` slots (slot =
pos % window), others write at pos. Nothing in it reads a tensor on the
host, so one decode step can be captured as a CUDA graph.

Each query chunk's body is rematerialized (``layers.remat``): its scores
and softmax are recomputed in the backward, not kept per chunk.

On a bound mesh (``shard_ctx.set_axes``) the training path takes the JAX
package's layout: "head" where the kv heads or the q heads divide the
model axis (``head_tp_available``; each model slot runs its block of the
heads, kv repeated group-wise when only the q heads divide), else "key"
(the keys split over the model slots, the window folded into the mask,
no banded slice). With no mesh the model axis is 1 and the path is the
one-slot one above.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .layers import (Init, _dense_init, apply_rope, dot_f32, einsum_f32,
                     matmul, qk_norm, remat)
from .shard_ctx import columns, constrain, executor, model_size, rows

Tensor = torch.Tensor
NEG_INF = -1e30


# -- parameter init -------------------------------------------------------------
def init_gqa(init: Init, d_model: int, n_heads: int, n_kv: int, d_head: int,
             dtype, *, use_bias: bool = False) -> dict:
    p = {
        "wq": _dense_init(init, (d_model, n_heads * d_head), dtype),
        "wk": _dense_init(init, (d_model, n_kv * d_head), dtype),
        "wv": _dense_init(init, (d_model, n_kv * d_head), dtype),
        "wo": _dense_init(init, (n_heads * d_head, d_model), dtype),
    }
    if use_bias:
        p["bq"] = init.zeros((n_heads * d_head,), dtype)
        p["bk"] = init.zeros((n_kv * d_head,), dtype)
        p["bv"] = init.zeros((n_kv * d_head,), dtype)
        p["bo"] = init.zeros((d_model,), dtype)
    return p


def init_mla(init: Init, d_model: int, n_heads: int, mla, dtype) -> dict:
    qk = mla.qk_nope_dim + mla.qk_rope_dim
    return {
        "w_dq": _dense_init(init, (d_model, mla.q_lora_rank), dtype),
        "w_uq": _dense_init(init, (mla.q_lora_rank, n_heads * qk), dtype),
        "w_dkv": _dense_init(
            init, (d_model, mla.kv_lora_rank + mla.qk_rope_dim), dtype),
        "w_uk": _dense_init(
            init, (mla.kv_lora_rank, n_heads * mla.qk_nope_dim), dtype),
        "w_uv": _dense_init(
            init, (mla.kv_lora_rank, n_heads * mla.v_dim), dtype),
        "wo": _dense_init(init, (n_heads * mla.v_dim, d_model), dtype),
    }


# -- shared helpers ---------------------------------------------------------------
def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _split_heads(x: Tensor, n: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _proj_qkv(params, x, x_kv, n_heads, n_kv):
    q = matmul(x, params["wq"])
    k = matmul(x_kv, params["wk"])
    v = matmul(x_kv, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    spec = ("data", None, "model", None)  # heads over TP when divisible
    return (constrain(_split_heads(q, n_heads), spec),
            constrain(_split_heads(k, n_kv), spec),
            constrain(_split_heads(v, n_kv), spec))


def head_tp_available(h: int, hkv: int) -> bool:
    """Can attention shard over heads on the model axis? Either kv heads
    divide it, or q heads do (then kv is repeated group-wise)."""
    msz = model_size()
    return (hkv % msz == 0 and hkv >= msz) or (h % msz == 0 and h >= msz)


def _sdpa(q, k, v, mask, scale, *, train_layout: str | bool = False):
    """q: (B, Q, H, Dh); k/v: (B, K, Hkv, Dh); mask: (B, Q, K) bool or None.
    GQA via head grouping; scores float32.

    train_layout: False (decode) or "head" (one slot's heads: the
    executor splits the heads before the projections, so this is the
    single-slot product at local sizes), or "key" (KEY-dim parallel on a
    bound mesh: each model slot scores its block of the keys and keeps
    its max, sum-exp and P·V partial, combined as an online softmax over
    the slots; the layout for few-head archs where heads do not divide
    the model axis).
    """
    ex = executor()
    if train_layout == "key" and ex is not None \
            and k.shape[1] % ex.M == 0:
        return _sdpa_keys(ex, q, k, v, mask, scale)
    b, cq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, cq, hkv, rep, dh)
    s = einsum_f32("bqhrd,bkhd->bhrqk", qg, k) * scale
    if mask is not None:
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum_f32("bhrqk,bkhd->bqhrd", p.to(v.dtype), v)
    # note: v's head dim may differ from q/k's (MLA: qk=192, v=128)
    return o.reshape(b, cq, h, v.shape[-1]).to(q.dtype)


def _sdpa_keys(ex, q, k, v, mask, scale):
    """``_sdpa`` with the keys split over the model slots: slot (d, m)
    scores its data block's queries against key block m; the slots' max,
    sum-exp and P·V partials (float32) combine as an online softmax."""
    b, cq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    kb = k.shape[1] // ex.M
    xs = (q, k, v) if mask is None else (q, k, v, mask)

    def slot(m, _dev, qs, ks, vs, ms=None):
        keys = slice(m * kb, (m + 1) * kb)
        qg = qs.reshape(qs.shape[0], cq, hkv, rep, dh)
        s = einsum_f32("bqhrd,bkhd->bhrqk", qg, ks[:, keys]) * scale
        if ms is not None:
            s = torch.where(ms[:, None, None, :, keys], s, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        pv = einsum_f32("bhrqk,bkhd->bqhrd", e.to(vs.dtype), vs[:, keys])
        return mx, e.sum(-1, keepdim=True), pv

    def combine(line):
        top = torch.stack([mx for mx, _, _ in line]).amax(0)
        den, num = 0.0, 0.0
        for mx, l, pv in line:
            w = torch.exp(mx - top)                       # (b, h, r, q, 1)
            den = den + w * l
            num = num + pv * w[..., 0].permute(0, 3, 1, 2)[..., None]
        return num / den[..., 0].permute(0, 3, 1, 2)[..., None]

    o = ex.per_slot(slot, xs, combine)
    # the max, the sum-exp and the P·V partials, float32, over the slots
    stats = 2 * o.numel() // o.shape[-1]
    ex.count("all_reduce", ex.M * 4 * (stats + o.numel()), over=ex.M,
             per_line=True)
    return o.reshape(b, cq, h, v.shape[-1]).to(q.dtype)


def _chunks(s: int, q_chunk: int) -> tuple:
    """(chunk length, chunk count): ``q_chunk`` where it divides s, else
    one chunk."""
    cq = min(q_chunk, s)
    nch = s // cq if s % cq == 0 else 1
    return s // nch, nch


def _attend(q, k, v, positions, kv_pos, *, scale, causal, window, cross,
            q_chunk, mode):
    """The query-chunked scores of (B, S, H, Dh) q against k/v: (B, S,
    H * Dv). ``mode`` "head" takes the banded key slice on sliding-window
    layers; "key" folds the window into the mask over every key (the key
    split precludes the banded slice)."""
    b, s = q.shape[:2]
    cq, nch = _chunks(s, q_chunk)
    sk = k.shape[1]
    banded = window is not None and not cross and mode == "head"

    def chunk_body(qs, qp, ks, vs, kp):
        if window is not None and not cross:
            m = (qp[:, :, None] >= kp[:, None, :]) & (
                qp[:, :, None] - kp[:, None, :] < window)
        elif causal and not cross:
            m = qp[:, :, None] >= kp[:, None, :]
        else:
            m = None
        return _sdpa(qs, ks, vs, m, scale, train_layout=mode)

    outs = []
    for idx in range(nch):
        start = idx * cq
        keys = slice(None)
        if banded:
            # banded: only the (window + cq) key slice can be visible
            band = min(window + cq, sk)
            kstart = max(start + cq - band, 0)
            keys = slice(kstart, kstart + band)
        # remat: scores and softmax are recomputed in the backward
        outs.append(remat(chunk_body, q[:, start:start + cq],
                          positions[:, start:start + cq], k[:, keys],
                          v[:, keys], kv_pos[:, keys]))
    return torch.cat(outs, dim=1).reshape(b, s, -1)


def _qkv_heads(params, x, src, positions, kv_pos, *, n_heads, n_kv,
               use_qk_norm, rope_theta, cross):
    q, k, v = _proj_qkv(params, x, src, n_heads, n_kv)
    if use_qk_norm:
        q, k = qk_norm(q), qk_norm(k)
    if rope_theta is not None and not cross:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_pos, rope_theta)
    return q, k, v


def attention_train(params: dict, x: Tensor, positions: Tensor, *,
                    n_heads: int, n_kv: int, d_head: int,
                    rope_theta: float | None, causal: bool = True,
                    window: int | None = None, use_qk_norm: bool = False,
                    q_chunk: int = 512, x_kv: Optional[Tensor] = None,
                    kv_positions: Optional[Tensor] = None) -> Tensor:
    """Full-sequence attention (training / prefill), query-chunked.

    window: static int for banded sliding-window attention, None for full.
    x_kv/kv_positions: cross-attention source (whisper decoder).
    """
    cross = x_kv is not None
    src = x_kv if cross else x
    kv_pos = kv_positions if cross else positions
    scale = 1.0 / np.sqrt(d_head)
    # few-head archs (gemma3-4b: 8, llama4: 40, whisper: 8) cannot shard
    # heads over a wide model axis: shard the KEY dim instead; with no
    # mesh the model axis is 1 and the mode is "head"
    mode = "head" if head_tp_available(n_heads, n_kv) else "key"
    kw = dict(scale=scale, causal=causal, window=window, cross=cross,
              q_chunk=q_chunk, mode=mode)
    proj = dict(use_qk_norm=use_qk_norm, rope_theta=rope_theta, cross=cross)
    ex = executor()
    if ex is not None and mode == "head":
        out = _attention_heads(ex, params, x, src, positions, kv_pos,
                               n_heads=n_heads, n_kv=n_kv, d_head=d_head,
                               proj=proj, kw=kw)
    else:
        if ex is not None:      # key mode: the projections replicated
            params = ex.replicate_tree(params)
        q, k, v = _qkv_heads(params, x, src, positions, kv_pos,
                             n_heads=n_heads, n_kv=n_kv, **proj)
        out = matmul(_attend(q, k, v, positions, kv_pos, **kw), params["wo"])
    if "bo" in params:
        out = out + params["bo"]
    return out


def _attention_heads(ex, params, x, src, positions, kv_pos, *, n_heads,
                     n_kv, d_head, proj, kw):
    """Head-parallel attention on a bound mesh: model slot m projects its
    block of the q heads (and the kv heads they read, repeated group-wise
    where the kv heads do not divide the model axis: Megatron GQA), runs
    the single-slot attention at local sizes, and multiplies by its row
    block of ``wo``; the float32 partials are summed over the slots."""
    hl = n_heads // ex.M
    rep = n_heads // n_kv
    split_kv = n_kv % ex.M == 0 and n_kv >= ex.M

    def cols(name, first, count, dev):
        w = ex.narrow(params[name], 1, first * d_head, count * d_head, dev)
        b = None
        if "b" + name[1:] in params:
            b = ex.narrow(params["b" + name[1:]], 0, first * d_head,
                          count * d_head, dev)
        return w, b

    def slot(m, dev, xs, ss, qp, kp):
        if split_kv:
            lo, nk = m * (n_kv // ex.M), n_kv // ex.M
        else:
            lo = m * hl // rep
            nk = ((m + 1) * hl - 1) // rep + 1 - lo
        local = {}
        local["wq"], bq = cols("wq", m * hl, hl, dev)
        local["wk"], bk = cols("wk", lo, nk, dev)
        local["wv"], bv = cols("wv", lo, nk, dev)
        if bq is not None:
            local.update(bq=bq, bk=bk, bv=bv)
        q, k, v = _qkv_heads(local, xs, ss, qp, kp, n_heads=hl, n_kv=nk,
                             **proj)
        if not split_kv:
            # each local q head's kv head, repeated (rep 1 locally)
            idx = (torch.arange(m * hl, (m + 1) * hl, device=dev) // rep
                   - lo)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        o = _attend(q, k, v, qp, kp, **kw)
        wo = ex.narrow(params["wo"], 0, m * hl * d_head, hl * d_head, dev)
        return dot_f32(o, wo)

    return ex.row_parallel(slot, (x, src, positions, kv_pos), x.dtype)


def _write_rows(cache: Tensor, new: Tensor, slot: Tensor) -> None:
    """cache[b, slot[b]] = new[b] for every batch row, in place; the slot
    clamped into the cache as ``dynamic_update_slice`` clamps it."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long().clamp(0, cache.shape[1] - 1)] = new


def _decode_proj(params, x, positions, *, n_heads, n_kv, rope_theta,
                 use_qk_norm):
    """q, k, v of one new token per row: (B, 1, heads, Dh)."""
    q, k_new, v_new = _proj_qkv(params, x, x, n_heads, n_kv)
    if use_qk_norm:
        q, k_new = qk_norm(q), qk_norm(k_new)
    if rope_theta is not None:
        q = apply_rope(q, positions[:, None], rope_theta)
        k_new = apply_rope(k_new, positions[:, None], rope_theta)
    return q, k_new, v_new


def _visible(positions: Tensor, idx: Tensor, s_max: int,
             window: int | None) -> Tensor:
    """(B, len(idx)) bool: which cache slots `idx` hold a position each
    row's query sees. A ring buffer's slot j holds the largest position
    p <= the current one with p % s_max == j."""
    cur = positions[:, None].long()
    idx = idx[None, :]
    if window is None:
        return idx <= cur
    p_j = cur - ((cur - idx) % s_max)
    return (p_j >= 0) & (cur - p_j < window) & (p_j <= cur)


def attention_decode(params: dict, cache: dict, x: Tensor,
                     positions: Tensor, *, n_heads: int, n_kv: int,
                     d_head: int, rope_theta: float | None,
                     window: int | None = None,
                     use_qk_norm: bool = False) -> tuple:
    """One-token decode against a (B, S_max, Hkv, Dh) cache.

    cache: {"k": ..., "v": ...}, written in place; positions: (B,)
    write/attend index. Returns (out (B, 1, D), cache). Sliding-window
    layers use a ring-buffer cache of size `window` (slot = pos % window).
    On a bound mesh the cache leaves are its blocks (``_decode_mesh``).
    """
    kw = dict(n_heads=n_heads, n_kv=n_kv, d_head=d_head,
              rope_theta=rope_theta, window=window, use_qk_norm=use_qk_norm)
    ex = executor()
    if ex is not None:
        return _decode_mesh(ex, params, cache, x, positions, **kw), cache
    return _decode_one(params, cache, x, positions, **kw), cache


def _decode_one(params, cache, x, positions, *, n_heads, n_kv, d_head,
                rope_theta, window, use_qk_norm) -> Tensor:
    """``attention_decode`` on whole tensors: (B, 1, D)."""
    b = x.shape[0]
    q, k_new, v_new = _decode_proj(params, x, positions, n_heads=n_heads,
                                   n_kv=n_kv, rope_theta=rope_theta,
                                   use_qk_norm=use_qk_norm)
    s_max = cache["k"].shape[1]
    slot = positions % s_max if window is not None else positions
    _write_rows(cache["k"], k_new[:, 0], slot)
    _write_rows(cache["v"], v_new[:, 0], slot)
    visible = _visible(positions, torch.arange(s_max, device=x.device),
                       s_max, window)
    scale = 1.0 / np.sqrt(d_head)
    out = _sdpa(q, cache["k"], cache["v"], visible[:, None, :], scale)
    out = matmul(out.reshape(b, 1, n_heads * d_head), params["wo"])
    if "bo" in params:
        out = out + params["bo"]
    return out


def _partial(q, k, v, visible, scale) -> tuple:
    """Partial softmax statistics of one new token per row against a
    block of keys: q (b, 1, H, Dh), k/v (b, s, Hkv, Dh), visible (b, s)
    or None -> (max, sum-exp, P·V), float32, (b, H, 1), (b, H, 1),
    (b, H, Dv)."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    s = einsum_f32("bqhrd,bkhd->bhrqk", qg, k)[:, :, :, 0] * scale
    if visible is not None:
        s = torch.where(visible[:, None, None, :], s, NEG_INF)
    mx = s.amax(-1, keepdim=True)
    e = torch.exp(s - mx)
    acc = einsum_f32("bhrk,bkhd->bhrd", e.to(v.dtype), v)
    return (mx.reshape(b, h, 1), e.sum(-1, keepdim=True).reshape(b, h, 1),
            acc.reshape(b, h, -1))


def _decode_mesh(ex, params, cache, x, positions, *, n_heads, n_kv, d_head,
                 rope_theta, window, use_qk_norm) -> Tensor:
    """``attention_decode`` on a bound mesh, the cache placed by
    ``cache_specs``: each slot writes the new K/V into its block where the
    block holds the position and scores its rows against its block; the
    partials combine (``Executor.cache_partials``). Where the model axis
    splits the kv heads, each model slot projects its heads (its column
    blocks of wq/wk/wv) and multiplies by its row block of wo, the
    partials summed; else the projections run replicated. A cache of any
    other layout is gathered whole, decoded and its new row written back
    into the blocks."""
    from repro_torch.distributed.executor import masked_write

    ck, cv = cache["k"], cache["v"]
    s_max = ck.shape[1]
    scale = 1.0 / np.sqrt(d_head)
    kw = dict(n_heads=n_heads, n_kv=n_kv, rope_theta=rope_theta,
              use_qk_norm=use_qk_norm)
    ring = window is not None
    heads = ck.mdim == 2 and ck.ddim in (None, 0, 1) \
        and (cv.ddim, cv.mdim) == (ck.ddim, ck.mdim)
    b = x.shape[0]
    if not heads:
        params = ex.replicate_tree(params)
    if not heads and (ck.ddim not in (None, 0, 1) or ck.mdim not in (None, 1)
                      or (cv.ddim, cv.mdim) != (ck.ddim, ck.mdim)):
        whole = {"k": ex.gather_leaf(ck), "v": ex.gather_leaf(cv)}
        out = _decode_one(params, whole, x, positions, d_head=d_head,
                          window=window, **kw)
        slot = (positions % s_max if ring else positions).long().clamp(
            0, s_max - 1)
        rows = torch.arange(b, device=x.device)
        for name, leaf in (("k", ck), ("v", cv)):
            ex.write_rows(leaf, whole[name][rows, slot], slot)
        return out

    nk = n_kv // ex.M if heads else n_kv
    hl = n_heads // ex.M if heads else n_heads

    def local(m, dev, xs, ps):
        """The slot's q, k, v from its heads' columns."""
        p = {}
        for name, first, count in (("q", m * hl, hl), ("k", m * nk, nk),
                                   ("v", m * nk, nk)):
            p["w" + name] = ex.narrow(params["w" + name], 1,
                                      first * d_head, count * d_head, dev)
            if "b" + name in params:
                p["b" + name] = ex.narrow(params["b" + name], 0,
                                          first * d_head, count * d_head,
                                          dev)
        return _decode_proj(p, xs, ps, **dict(kw, n_heads=hl, n_kv=nk))

    def slot(m, dev, blocks, start, *rows):
        if heads:
            q, k_new, v_new = local(m, dev, *rows)
            ps = rows[1]
        else:
            q, k_new, v_new, ps = rows
        kb, vb = blocks
        at = (ps % s_max if ring else ps) - start
        masked_write(kb, k_new[:, 0], at)
        masked_write(vb, v_new[:, 0], at)
        idx = torch.arange(start, start + kb.shape[1], device=dev)
        return _partial(q, kb, vb, _visible(ps, idx, s_max, window), scale)

    if heads:
        xs = (x, positions)
    else:
        xs = (*_decode_proj(params, x, positions, **kw), positions)
    mx, l, acc = ex.cache_partials((ck, cv), xs, slot, heads_dim=1)
    o = (acc / l).reshape(b, 1, n_heads * d_head).to(x.dtype)
    if not heads:
        out = matmul(o, params["wo"])
    else:
        out = ex.row_parallel(lambda m, dev, os: dot_f32(
            os[..., m * hl * d_head:(m + 1) * hl * d_head],
            ex.narrow(params["wo"], 0, m * hl * d_head, hl * d_head, dev)),
            (o,), x.dtype)
    return out + params["bo"] if "bo" in params else out


def cross_decode(q: Tensor, cache: dict, scale: float) -> Tensor:
    """One new token per row against a precomputed (cross-attention)
    cache, all of it visible: (B, 1, H, Dv). On a bound mesh each slot
    scores its block (its q heads where the model axis splits the kv
    heads) and the partials combine; a cache of another layout is
    gathered whole."""
    ex = executor()
    if ex is None:
        return _sdpa(q, cache["k"], cache["v"], None, scale)
    ck, cv = cache["k"], cache["v"]
    if ck.ddim not in (None, 0, 1) or ck.mdim not in (None, 1, 2):
        return _sdpa(q, ex.gather_leaf(ck), ex.gather_leaf(cv), None, scale)
    hl = q.shape[2] // ex.M

    def slot(m, dev, blocks, start, qs):
        if ck.mdim == 2:
            qs = qs[:, :, m * hl:(m + 1) * hl]
        return _partial(qs, blocks[0], blocks[1], None, scale)

    mx, l, acc = ex.cache_partials((ck, cv), (q,), slot, heads_dim=1)
    return (acc / l).reshape(q.shape[0], 1, q.shape[2], -1).to(q.dtype)


def cross_attention_decode(params: dict, cache: dict, x: Tensor, *,
                           n_heads: int, d_head: int) -> Tensor:
    """One new token per row against a precomputed cross-attention cache
    (whisper's decoder): q from `x`, the scores (``cross_decode``), ``wo``.
    On a bound mesh where the model axis splits the cache's kv heads each
    slot projects its q heads (its columns of ``wq``) against its block;
    else q is column-parallel and gathered. ``wo`` is row-parallel where
    the model axis splits its rows."""
    b = x.shape[0]
    scale = 1.0 / np.sqrt(d_head)
    ex = executor()
    ck, cv = cache["k"], cache["v"]
    if ex is not None and ck.mdim == 2 and ck.ddim in (None, 0, 1) \
            and (cv.ddim, cv.mdim) == (ck.ddim, ck.mdim):
        hl = n_heads // ex.M

        def slot(m, dev, blocks, start, xs):
            q = matmul(xs, ex.narrow(params["wq"], 1, m * hl * d_head,
                                     hl * d_head, dev))
            if "bq" in params:
                q = q + ex.narrow(params["bq"], 0, m * hl * d_head,
                                  hl * d_head, dev)
            return _partial(q.reshape(xs.shape[0], 1, hl, d_head),
                            blocks[0], blocks[1], None, scale)

        _, l, acc = ex.cache_partials((ck, cv), (x,), slot, heads_dim=1)
        o = (acc / l).reshape(b, 1, n_heads * d_head).to(x.dtype)
    else:
        q = columns(matmul, x, params["wq"])
        if "bq" in params:
            q = q + params["bq"]
        o = cross_decode(q.reshape(b, 1, n_heads, d_head), cache, scale)
        o = o.reshape(b, 1, n_heads * d_head)
    out = rows(o, params["wo"])
    return out + params["bo"] if "bo" in params else out


# -- MLA (deepseek-v2) -------------------------------------------------------------
def _mla_latents(params, x) -> tuple:
    """The query and kv latents (B, S, q_lora), (B, S, kv_lora + rope):
    column-parallel on a bound mesh, gathered whole on the line's device
    (the up-projections contract them)."""
    return (columns(matmul, x, params["w_dq"]),
            columns(matmul, x, params["w_dkv"]))


def _mla_heads(ex, n_heads: int) -> bool:
    """Do MLA's heads split over the bound mesh's model slots?"""
    return ex is not None and n_heads % ex.M == 0


def _mla_attend(w_uq, w_uk, w_uv, cq_lat, c_kv, k_pe, positions, *,
                n_heads: int, mla, q_chunk: int) -> Tensor:
    """`n_heads` heads of MLA from the latents, query-chunked: (B, S,
    n_heads · v_dim); ``w_uq``/``w_uk``/``w_uv`` those heads' columns."""
    b, s, _ = cq_lat.shape
    nope, rope, vd = mla.qk_nope_dim, mla.qk_rope_dim, mla.v_dim
    q = _split_heads(matmul(cq_lat, w_uq), n_heads)         # (B,S,H,qk)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, 10_000.0)
    k_nope = _split_heads(matmul(c_kv, w_uk), n_heads)
    v = _split_heads(matmul(c_kv, w_uv), n_heads)
    k = torch.cat([k_nope, k_pe.expand(b, s, n_heads, rope)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    scale = 1.0 / np.sqrt(nope + rope)
    cqs, nch = _chunks(s, q_chunk)

    def chunk_body(qs, qp):
        return _sdpa(qs, k, v, qp[:, :, None] >= positions[:, None, :],
                     scale)

    outs = [remat(chunk_body, qq[:, i * cqs:(i + 1) * cqs],
                  positions[:, i * cqs:(i + 1) * cqs]) for i in range(nch)]
    return torch.cat(outs, dim=1).reshape(b, s, n_heads * vd)


def mla_train(params: dict, x: Tensor, positions: Tensor, *, n_heads: int,
              mla, q_chunk: int = 512) -> Tensor:
    """MLA over the full sequence. On a bound mesh where the heads divide
    the model axis each slot runs its block of the heads (``w_uq``,
    ``w_uk``, ``w_uv`` are head-major) from the whole latents and
    multiplies by its rows of ``wo``, the float32 partials summed."""
    ex = executor()
    split = _mla_heads(ex, n_heads)
    if ex is not None and not split:
        params = ex.replicate_tree(params)     # the heads do not divide
    cq_lat, ckv = _mla_latents(params, x)
    c_kv, k_pe = ckv[..., :mla.kv_lora_rank], ckv[..., mla.kv_lora_rank:]
    k_pe = apply_rope(k_pe[:, :, None, :], positions, 10_000.0)  # (B,S,1,r)
    kw = dict(mla=mla, q_chunk=q_chunk)
    if not split:
        return matmul(_mla_attend(params["w_uq"], params["w_uk"],
                                  params["w_uv"], cq_lat, c_kv, k_pe,
                                  positions, n_heads=n_heads, **kw),
                      params["wo"])
    hl = n_heads // ex.M

    def slot(m, dev, cq, ck, kp, ps):
        w = [ex.part(params[n], 1, m, dev) for n in ("w_uq", "w_uk", "w_uv")]
        o = _mla_attend(*w, cq, ck, kp, ps, n_heads=hl, **kw)
        return dot_f32(o, ex.part(params["wo"], 0, m, dev))

    return ex.row_parallel(slot, (cq_lat, c_kv, k_pe, positions), x.dtype)


def _mla_query(w_uq, w_uk, cq_lat, positions, n_heads: int, mla,
               dtype) -> tuple:
    """One new token's absorbed query of `n_heads` heads: (q_lat (B, 1,
    H, kv_lora), q_pe (B, 1, H, rope)), W_uk absorbed into q."""
    nope, lat = mla.qk_nope_dim, mla.kv_lora_rank
    q = _split_heads(matmul(cq_lat, w_uq), n_heads)         # (B,1,H,qk)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions[:, None], 10_000.0)
    q_lat = einsum_f32("bqhn,lhn->bqhl", q_nope,
                       w_uk.reshape(lat, n_heads, nope)).to(dtype)
    return q_lat, q_pe


def _mla_value(w_uv, o_lat, n_heads: int, mla, dtype) -> Tensor:
    """The heads' values from their latent outputs: (B, 1, H · v_dim)."""
    o = einsum_f32("bqhl,lhv->bqhv", o_lat,
                   w_uv.reshape(mla.kv_lora_rank, n_heads, mla.v_dim))
    return o.to(dtype).reshape(o_lat.shape[0], 1, n_heads * mla.v_dim)


def mla_decode(params: dict, cache: dict, x: Tensor, positions: Tensor, *,
               n_heads: int, mla) -> tuple:
    """Absorbed-matrix MLA decode: the cache holds only the latent
    (kv_lora + rope) per token, written in place at each row's position.
    On a bound mesh where the heads divide the model axis each slot forms
    its heads' absorbed queries (gathered for the scores against the
    latent cache, ``_mla_mesh``) and their values times its rows of
    ``wo``.

    cache: {"ckv": (B, S, kv_lora), "kpe": (B, S, rope)}.
    """
    lat = mla.kv_lora_rank
    ex = executor()
    split = _mla_heads(ex, n_heads)
    if ex is not None and not split:
        params = ex.replicate_tree(params)     # the heads do not divide
    cq_lat, ckv_new = _mla_latents(params, x)
    c_new, kpe_new = ckv_new[..., :lat], ckv_new[..., lat:]
    kpe_new = apply_rope(kpe_new[:, :, None, :], positions[:, None],
                         10_000.0)[:, :, 0, :]
    if split:
        hl = n_heads // ex.M
        q_lat, q_pe = ex.per_slot(
            lambda m, dev, cq, ps: _mla_query(
                ex.part(params["w_uq"], 1, m, dev),
                ex.part(params["w_uk"], 1, m, dev), cq, ps, hl, mla,
                x.dtype),
            (cq_lat, positions),
            lambda line: tuple(torch.cat(z, dim=2) for z in zip(*line)))
        ex.count("all_gather", ex.M * (_nbytes(q_lat) + _nbytes(q_pe))
                 * ex.D, over=ex.M)
    else:
        q_lat, q_pe = _mla_query(params["w_uq"], params["w_uk"], cq_lat,
                                 positions, n_heads, mla, x.dtype)
    denom = np.sqrt(mla.qk_nope_dim + mla.qk_rope_dim)
    native = ex is not None and all(
        cache[n].ddim in (None, 0, 1) and cache[n].mdim in (None, 1)
        and (cache[n].ddim, cache[n].mdim) == (cache["ckv"].ddim,
                                               cache["ckv"].mdim)
        for n in ("ckv", "kpe"))
    if native:
        o_lat = _mla_mesh(ex, cache, q_lat, q_pe, c_new, kpe_new,
                          positions, 1.0 / denom)
    else:
        lat_cache = cache
        if ex is not None:          # another layout: gathered whole
            for name, new in (("ckv", c_new), ("kpe", kpe_new)):
                ex.write_rows(cache[name], new[:, 0], positions)
            lat_cache = {n: ex.gather_leaf(cache[n]) for n in ("ckv", "kpe")}
        _write_rows(lat_cache["ckv"], c_new[:, 0], positions)
        _write_rows(lat_cache["kpe"], kpe_new[:, 0], positions)
        ckv, kpe = lat_cache["ckv"], lat_cache["kpe"]
        s_max = ckv.shape[1]
        scores = (einsum_f32("bqhl,bkl->bhqk", q_lat, ckv)
                  + einsum_f32("bqhr,bkr->bhqk", q_pe, kpe)) / denom
        visible = torch.arange(s_max, device=x.device)[None, None, None, :] \
            <= positions[:, None, None, None]
        scores = torch.where(visible, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        o_lat = einsum_f32("bhqk,bkl->bqhl", p.to(x.dtype), ckv).to(x.dtype)
    if not split:
        return matmul(_mla_value(params["w_uv"], o_lat, n_heads, mla,
                                 x.dtype), params["wo"]), cache
    return ex.row_parallel(
        lambda m, dev, ol: dot_f32(_mla_value(
            ex.part(params["w_uv"], 1, m, dev),
            ol[:, :, m * hl:(m + 1) * hl], hl, mla, x.dtype),
            ex.part(params["wo"], 0, m, dev)),
        (o_lat,), x.dtype), cache


def _mla_mesh(ex, cache, q_lat, q_pe, c_new, kpe_new, positions,
              scale) -> Tensor:
    """The absorbed MLA scores on a bound mesh (the latent cache's batch
    and sequence placed by ``cache_specs``): each slot writes the new
    latent into its blocks where they hold the position, scores its rows
    against them, and the partials combine. -> o_lat (B, 1, H, lat)."""
    from repro_torch.distributed.executor import masked_write

    def slot(m, dev, blocks, start, ql, qp, cn, kn, ps):
        cb, kb = blocks
        masked_write(cb, cn[:, 0], ps - start)
        masked_write(kb, kn[:, 0], ps - start)
        s = (einsum_f32("bqhl,bkl->bhqk", ql, cb)
             + einsum_f32("bqhr,bkr->bhqk", qp, kb))[:, :, 0] * scale
        idx = torch.arange(start, start + cb.shape[1], device=dev)
        s = torch.where(idx[None, None, :] <= ps[:, None, None], s, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx)
        acc = einsum_f32("bhk,bkl->bhl", e.to(ql.dtype), cb)
        return mx, e.sum(-1, keepdim=True), acc

    mx, l, acc = ex.cache_partials(
        (cache["ckv"], cache["kpe"]), (q_lat, q_pe, c_new, kpe_new,
                                       positions), slot, heads_dim=None)
    return (acc / l)[:, None].to(q_lat.dtype)
