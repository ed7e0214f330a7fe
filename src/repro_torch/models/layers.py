"""Shared layers: norms, rotary embeddings, MLPs, embedding tables.

Plain functions over nested dicts of tensors, as in the JAX package's
``repro.models.layers``: ``init_*`` returns a params dict, the matching
apply is a plain function. Every matmul runs in the activation dtype with
float32 accumulation and casts back (``matmul``); norms and softmax run in
float32. Parameters are drawn from an explicit ``torch.Generator`` on the
device given by ``Init``; on the ``meta`` device nothing is drawn or
allocated (``Model.param_count``).

Everything here is differentiable by autograd. On the card the bfloat16
products carry their own backward (``_DotF32``, ``_MatmulCast``): the
transpose of ``dot_general(preferred_element_type=float32)``, each product
accumulated in float32. ``remat`` is ``jax.checkpoint``: the activations
of its body are recomputed in the backward.

On a bound mesh (``shard_ctx``) ``mlp`` splits d_ff over the model slots,
``embed`` and ``unembed_sums`` the vocabulary (a masked lookup summed
over the slots; a log-sum-exp combined over them). ``unembed_sums`` is
the JAX package's ``unembed_chunked`` before its division: the masked
sum and the count, which a mesh reduces over its lines first.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Tensor = torch.Tensor


@dataclasses.dataclass
class Init:
    """Where parameters are drawn: a generator (None: the device's
    default) and a device (``meta`` draws nothing)."""

    generator: Optional[torch.Generator]
    device: torch.device

    def empty(self, shape, dtype) -> Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype) -> Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full(self, shape, value, dtype) -> Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _dense_init(init: Init, shape, dtype, scale=None) -> Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in),
    fan_in = shape[0]), drawn in float32 and cast to `dtype`."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if init.device.type == "meta":
        return init.empty(shape, dtype)
    w = torch.empty(shape, dtype=torch.float32, device=init.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=init.generator)
    return (w.mul_(float(scale))).to(dtype)


def _records(*args) -> bool:
    """Whether autograd records an op on `args`: grad mode on and a
    tensor among them (in dicts, lists and tuples too) requiring grad."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(a):
        if isinstance(a, Tensor):
            return a.requires_grad
        if isinstance(a, dict):
            return any(any_grad(v) for v in a.values())
        if isinstance(a, (list, tuple)):
            return any(any_grad(v) for v in a)
        return False

    return any_grad(args)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward rather
    than kept (``jax.checkpoint``). Only where autograd records through
    `args`: elsewhere (prefill, the decode step and its captured graph)
    ``fn`` runs as it is. Non-reentrant, so that checkpoints nest (a
    chunk's inside a layer group's) and tensors ``fn`` closes over get
    their gradients; the model draws no random numbers, so no RNG state
    is stashed for the recompute."""
    if not _records(*args):
        return fn(*args)
    from .shard_ctx import restored, snapshot

    snap = snapshot()

    def run(*a):
        # the recompute issues its ops as the first run did, on its line
        with restored(snap):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def _mm_f32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of 2-D low-precision operands, accumulated and returned
    in float32 (cuBLAS; the operands stay in their dtype)."""
    return torch.mm(a, b, out_dtype=torch.float32)


def bf16_terms(g: Tensor, dtype) -> tuple:
    """A float32 tensor as two terms of `dtype`, ``hi = dtype(g)`` and
    ``lo = dtype(g - hi)``: 16 of float32's 24 significand bits."""
    hi = g.to(dtype)
    return hi, (g - hi.float()).to(dtype)


def dot_vjp_f32(x2: Tensor, w: Tensor, parts, need=(True, True)) -> tuple:
    """(dx, dw) of ``x2 @ w`` in float32, for the cotangent given as the
    sum of `parts` (each exact in the operands' dtype): ``parts @ w.T``
    and ``x2.T @ parts``, each product accumulated in float32 and the
    products summed. ``need`` skips a gradient (None)."""
    dx = sum(_mm_f32(g, w.t()) for g in parts) if need[0] else None
    dw = sum(_mm_f32(x2.t(), g) for g in parts) if need[1] else None
    return dx, dw


def _dot_backward(ctx, x2, w, parts) -> tuple:
    """The operands' gradients: ``dot_vjp_f32`` cast to their dtypes.
    (`x2`, `w`: the saved tensors, unpacked once by the caller, as a
    checkpointed region allows.)"""
    dx, dw = dot_vjp_f32(x2, w, parts, ctx.needs_input_grad[:2])
    return (None if dx is None else dx.to(x2.dtype).reshape(ctx.x_shape),
            None if dw is None else dw.to(w.dtype))


class _DotF32(torch.autograd.Function):
    """``x @ w`` in float32 from low-precision operands on the card. Its
    cotangent is a true float32 (the logits'), so the backward takes it
    as two terms of the operands' dtype (``bf16_terms``), one product
    each, where widening the (vocab x d_model) table would copy it in
    float32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x.reshape(-1, x.shape[-1]), w)
        ctx.x_shape = x.shape
        return _mm_f32_nd(x, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).float()
        return _dot_backward(ctx, x2, w, bf16_terms(g, w.dtype))


class _MatmulCast(torch.autograd.Function):
    """``matmul`` on the card: ``x @ w`` accumulated in float32 and cast
    to x's dtype. The cotangent arrives in that dtype, so the backward's
    products take it as it is (JAX widens it to float32, exactly)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x.reshape(-1, x.shape[-1]), w)
        ctx.x_shape = x.shape
        return _mm_f32_nd(x, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        return _dot_backward(ctx, x2, w, (g.reshape(-1, g.shape[-1]),))


def _low_on_card(x: Tensor, w: Tensor) -> bool:
    """Low-precision operands of one dtype on the card, or on ``meta``,
    which stands in for the card (the dry run counts the card's program:
    no float32 copies of the operands)."""
    return (x.device.type in ("cuda", "meta") and x.dtype == w.dtype
            and x.dtype != torch.float32)


def _mm_f32_nd(x: Tensor, w: Tensor) -> Tensor:
    """``_mm_f32`` over x's leading dims (no autograd of its own)."""
    out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` accumulated in float32 and cast back to x's dtype, as
    ``jnp.dot(..., preferred_element_type=float32).astype(x.dtype)``:
    the float32 result keeps every partial sum, split-K's included, in
    float32 whatever cuBLAS's reduced-precision setting."""
    if _low_on_card(x, w) and _records(x, w):
        return _MatmulCast.apply(x, w)
    return dot_f32(x, w).to(x.dtype)


def dot_f32(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` accumulated in float32 and returned in float32, as
    ``jnp.dot(..., preferred_element_type=float32)``. On the card the
    bfloat16 operands stay bfloat16 in memory (``torch.mm(out_dtype=)``,
    its backward ``_DotF32``); elsewhere they are widened, which is
    exact."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if _low_on_card(x, w):
        return _DotF32.apply(x, w) if _records(x, w) else _mm_f32_nd(x, w)
    return torch.matmul(x.float(), w.float())


def einsum_f32(eq: str, *ops: Tensor) -> Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: the operands
    widened to float32 (exact), the result float32; callers cast it back
    where the JAX package does (``.astype(x.dtype)``)."""
    return torch.einsum(eq, *(o.float() for o in ops))


# -- norms ---------------------------------------------------------------------
def init_rmsnorm(init: Init, d: int, dtype) -> dict:
    return {"scale": init.zeros((d,), dtype)}  # gemma-style (1 + scale)


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def qk_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    """Parameter-free RMS over the head dim (gemma3-style qk-norm, sans
    learned scale for simplicity of the stacked layout)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# -- rotary --------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> Tensor:
    """Inverse frequencies (float32)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=device) / dim
    return 1.0 / torch.pow(float(theta), exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int. Half-rotation convention."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = positions.float()[..., None] * inv              # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP -----------------------------------------------------------------------
def init_mlp(init: Init, d_model: int, d_ff: int, dtype, *, glu: bool,
             use_bias: bool) -> dict:
    p = {}
    if glu:
        p["gate"] = _dense_init(init, (d_model, d_ff), dtype)
    p["down"] = _dense_init(init, (d_ff, d_model), dtype)
    p["up"] = _dense_init(init, (d_model, d_ff), dtype)
    if use_bias:
        p["b_up"] = init.zeros((d_ff,), dtype)
        p["b_down"] = init.zeros((d_model,), dtype)
    return p


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(params: dict, x: Tensor, *, act: str, glu: bool) -> Tensor:
    from .shard_ctx import constrain, executor

    actfn = F.silu if act == "silu" else _gelu
    ex = executor()
    if ex is not None:
        if params["up"].shape[-1] % ex.M == 0:
            return _mlp_parallel(ex, params, x, actfn, glu)
        params = ex.replicate_tree(params)
    up = matmul(x, params["up"])
    if "b_up" in params:
        up = up + params["b_up"]
    h = actfn(matmul(x, params["gate"])) * up if glu else actfn(up)
    h = constrain(h, ("data", None, "model"))  # d_ff over TP
    out = matmul(h, params["down"])
    if "b_down" in params:
        out = out + params["b_down"]
    return out


def _mlp_parallel(ex, params: dict, x: Tensor, actfn, glu: bool) -> Tensor:
    """``mlp`` with d_ff over the model slots: slot m's columns of
    ``up``/``gate`` (and ``b_up``), its rows of ``down``; the float32
    partials summed over the slots and cast once, then ``b_down``."""
    def slot(m, dev, xs):
        up = matmul(xs, ex.part(params["up"], 1, m, dev))
        if "b_up" in params:
            up = up + ex.part(params["b_up"], 0, m, dev)
        h = actfn(matmul(xs, ex.part(params["gate"], 1, m, dev))) * up \
            if glu else actfn(up)
        return dot_f32(h, ex.part(params["down"], 0, m, dev))

    out = ex.row_parallel(slot, (x,), x.dtype)
    if "b_down" in params:
        out = out + params["b_down"]
    return out


# -- embeddings ------------------------------------------------------------------
def init_embedding(init: Init, vocab: int, d_model: int, dtype) -> dict:
    # GPT-2-style small init: keeps tied-embedding logits O(1) at init
    return {"table": _dense_init(init, (vocab, d_model), dtype, scale=0.02)}


def embed(params: dict, tokens: Tensor) -> Tensor:
    from .shard_ctx import executor

    ex = executor()
    table = params["table"]
    if ex is None:
        return F.embedding(tokens, table)
    if table.shape[0] % ex.M:
        return F.embedding(tokens, ex.full(table))
    rows = table.shape[0] // ex.M

    def slot(m, dev, tok):
        # the tokens in model slot m's vocabulary block, zeros elsewhere
        idx = tok.long() - m * rows
        inside = (idx >= 0) & (idx < rows)
        e = F.embedding(idx.clamp(0, rows - 1), ex.part(table, 0, m, dev))
        return e.float() * inside[..., None]

    return ex.row_parallel(slot, (tokens,), table.dtype)


def _vocab_parallel_ce(ex, table, h: Tensor, labels: Tensor) -> tuple:
    """(log-sum-exp, gold logit) of (B, C) positions with the vocabulary
    over the model slots: slot m's float32 logits against its rows of the
    (V, D) table, the log-sum-exps combined over the slots, the gold
    logit taken from the slot holding the label."""
    rows = table.shape[0] // ex.M

    def slot(m, dev, hs, ls):
        logits = dot_f32(hs, ex.part(table, 0, m, dev).t())   # (b, C, V/M)
        idx = ls.long() - m * rows
        inside = (idx >= 0) & (idx < rows)
        gold = logits.gather(-1, idx.clamp(0, rows - 1)[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1), gold * inside

    def combine(line):
        g = line[0][1]
        for _, b in line[1:]:
            g = g + b
        return torch.logsumexp(torch.stack([a for a, _ in line]), 0), g

    lse, gold = ex.per_slot(slot, (h, labels), combine)
    ex.count("all_reduce", ex.M * 2 * lse.numel() * 4, over=ex.M,
             per_line=True)
    return lse, gold


def unembed_sums(table: Tensor, h: Tensor, labels: Tensor, chunk: int,
                 mask: Optional[Tensor] = None) -> tuple:
    """(masked sum of the cross-entropy, count of the positions kept),
    float32 scalars (``tot / max(cnt, 1)`` is the JAX package's
    ``unembed_chunked``), WITHOUT materializing full (B, S, V) logits: the
    sequence in ``chunk``-sized slices, (B, chunk, V) logits at a time,
    each slice's recomputed in the backward rather than kept (V up to
    262k: the big-vocab guard); positions past the last whole chunk are
    dropped, as in the JAX package. Sums, so that rows split over a
    mesh's lines reduce to the global mean (``shard_ctx.line_stats``)."""
    from .shard_ctx import executor

    b, s, d = h.shape
    nchunk = max(s // chunk, 1)
    chunk = s // nchunk
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=h.device)
    ex = executor()
    tp = ex is not None and table.shape[0] % ex.M == 0
    if ex is not None and not tp:
        table = ex.full(table)
    table_t = None if tp else table.t()

    def body(hm, lm, mm):
        if tp:
            lse, gold = _vocab_parallel_ce(ex, table, hm, lm)
            return ((lse - gold) * mm).sum()
        logits = dot_f32(hm, table_t)                    # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lm[..., None].long())[..., 0]
        return ((lse - gold) * mm).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + remat(body, h[:, sl], labels[:, sl], mask[:, sl])
        cnt = cnt + mask[:, sl].sum()
    return tot, cnt
