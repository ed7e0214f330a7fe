"""Mixture-of-Experts with capacity-based dispatch (GShard/Switch style).

The JAX package's ``repro.models.moe`` in PyTorch. Top-k routing with
softmax-renormalized gates and a per-expert capacity
``C = ceil(g * k / E * capacity_factor)`` (at least 4) per sample and
sequence chunk of ``router_group_size`` tokens. Each (token, choice)
takes its place in its expert's buffer by a cumulative sum over one-hot
rows, counted per sample; a choice past the capacity is dropped (its gate
set to 0, so the token falls through to the residual path). Dispatch and
combine are one-hot einsums; the capacity is static, so nothing reads a
tensor on the host. Shared experts run densely for every token. The
router's load-balance and z losses come back as values
(``moe_stats_apply`` returns their batch means, per sequence chunk, and
``moe_aux`` combines them: on a mesh the means are first averaged over
the lines, ``shard_ctx.line_stats``, so that the load balance is the
product of the global means). Gradients flow through the gates and the
aux loss; the routing and the drops are discrete.

On a bound mesh (``shard_ctx``) the experts split over the model slots
(expert parallelism: each slot's one-hot einsums over its experts, the
partials summed over the slots); the router runs replicated.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (Init, _dense_init, einsum_f32, init_mlp, matmul, mlp,
                     remat)
from .shard_ctx import executor

Tensor = torch.Tensor


def init_moe(init: Init, d_model: int, moe_cfg, dtype) -> dict:
    e, f = moe_cfg.n_experts, moe_cfg.d_ff_expert
    p = {
        "router": _dense_init(init, (d_model, e), dtype, scale=0.02),
        # stacked expert GLU weights: (E, D, F) / (E, F, D)
        "gate": _dense_init(init, (e, d_model, f), dtype),
        "up": _dense_init(init, (e, d_model, f), dtype),
        "down": _dense_init(init, (e, f, d_model), dtype),
    }
    if moe_cfg.n_shared:
        p["shared"] = init_mlp(init, d_model, moe_cfg.n_shared * f, dtype,
                               glu=True, use_bias=False)
    return p


def _one_hot(idx: Tensor, n: int, dtype) -> Tensor:
    """One-hot rows by comparison: an index outside [0, n) gives a zero
    row, and nothing is checked on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch_chunk(params: dict, x: Tensor, moe_cfg, capacity: int) -> tuple:
    """One sequence chunk: x (B, g, D) -> (out (B, g, D), (density,
    prob_mass, z)): the means over the chunk's tokens of the experts'
    dispatch counts (no gradient), of the router probabilities, and of
    the router z-loss."""
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    b, g, d = x.shape
    ex = executor()
    experts_tp = ex is not None and e % ex.M == 0
    if ex is not None:
        # the router replicated; the experts too where they do not split
        params = dict(params, **{
            n: ex.full(params[n]) for n in ("router", "gate", "up", "down")
            if n == "router" or not experts_tp})
    logits = matmul(x, params["router"]).float()               # (B, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)       # (B, g, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) in its expert's capacity buffer,
    # counted independently per sample
    onehot = _one_hot(expert_idx, e, torch.int32)              # (B, g, k, E)
    flat = onehot.reshape(b, g * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(b, g, k, e)
    pos = (pos_in_expert * onehot).sum(-1)                     # (B, g, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep

    cap_oh = _one_hot(torch.where(keep, pos, capacity), capacity,
                      x.dtype)                                 # (B, g, k, C)
    disp = (onehot.to(x.dtype)[..., None]
            * cap_oh[..., None, :]).sum(2)                     # (B, g, E, C)
    comb = ((onehot.float() * gate_vals[..., None]
             ).to(x.dtype)[..., None] * cap_oh[..., None, :]).sum(2)

    if experts_tp:
        out = _experts_parallel(ex, params, x, disp, comb)
    else:
        out = _experts(params["gate"], params["up"], params["down"], x,
                       disp, comb).to(x.dtype)

    # aux: load-balance (Switch) + router z-loss, as their batch means
    density = onehot.sum(2).float().mean(dim=(0, 1))
    prob_mass = probs.mean(dim=(0, 1))
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out, (density, prob_mass, z)


def _experts(gate, up, down, x, disp, comb) -> Tensor:
    """The experts of `gate`/`up`/`down` on their dispatched tokens,
    combined: float32 (B, g, D)."""
    xin = einsum_f32("bgec,bgd->becd", disp, x).to(x.dtype)
    h = F.silu(einsum_f32("becd,edf->becf", xin, gate)
               ).to(x.dtype) * einsum_f32("becd,edf->becf", xin,
                                          up).to(x.dtype)
    xout = einsum_f32("becf,efd->becd", h, down).to(x.dtype)
    return einsum_f32("bgec,becd->bgd", comb, xout)


def _experts_parallel(ex, params, x, disp, comb) -> Tensor:
    """The experts over the model slots (expert parallelism): slot m runs
    its block of the experts on its dispatched tokens; the float32
    combined partials are summed over the slots and cast once."""
    n = params["gate"].shape[0] // ex.M

    def slot(m, dev, xs, ds, cs):
        own = slice(m * n, (m + 1) * n)
        return _experts(*(ex.part(params[w], 0, m, dev)
                          for w in ("gate", "up", "down")),
                        xs, ds[:, :, own], cs[:, :, own])

    return ex.row_parallel(slot, (x, disp, comb), x.dtype)


def moe_apply(params: dict, x: Tensor, moe_cfg) -> tuple:
    """x: (B, S, D) -> (out, aux_loss); sequence chunks one after another."""
    out, stats = moe_stats_apply(params, x, moe_cfg)
    return out, moe_aux(stats, moe_cfg)


def moe_stats_apply(params: dict, x: Tensor, moe_cfg) -> tuple:
    """x: (B, S, D) -> (out, stats): ``stats`` the chunks' ``(density,
    prob_mass, z)`` means over the batch's tokens, stacked over the
    sequence chunks ((n, E), (n, E), (n,)), for ``moe_aux``."""
    b, s, d = x.shape
    g = min(moe_cfg.router_group_size, s)
    nch = s // g
    if nch * g != s:
        raise ValueError(f"seq {s} not divisible by router group {g}")
    capacity = int(np.ceil(g * moe_cfg.top_k / moe_cfg.n_experts
                           * moe_cfg.capacity_factor))
    capacity = max(capacity, 4)

    if nch == 1:
        out, stats = _dispatch_chunk(params, x, moe_cfg, capacity)
        stats = [stats]
    else:
        outs, stats = [], []
        for c in range(nch):
            # remat: the dispatch one-hots and the expert buffers are
            # recomputed in the backward
            o, st = remat(_dispatch_chunk, params,
                          x[:, c * g:(c + 1) * g], moe_cfg, capacity)
            stats.append(st)
            outs.append(o)
        out = torch.cat(outs, dim=1)
    if "shared" in params:
        out = out + mlp(params["shared"], x, act="silu", glu=True)
    return out, tuple(torch.stack(z) for z in zip(*stats))


def moe_aux(stats: tuple, moe_cfg) -> Tensor:
    """The router's aux loss from ``moe_stats_apply``'s means: per chunk
    the Switch load balance ``E · Σ density / k · prob_mass`` and the
    z-loss, averaged over the chunks, ``(lb - 1)·1e-2 + z·1e-3``."""
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    density, prob_mass, z = stats
    nch = z.shape[0]
    if nch == 1:
        lb = e * (density[0] / k * prob_mass[0]).sum()
        return (lb - 1.0) * 1e-2 + z[0] * 1e-3
    lb = torch.zeros((), dtype=torch.float32, device=z.device)
    zs = torch.zeros((), dtype=torch.float32, device=z.device)
    for c in range(nch):
        lb = lb + e * (density[c] / k * prob_mass[c]).sum()
        zs = zs + z[c]
    return (lb / nch - 1.0) * 1e-2 + (zs / nch) * 1e-3
