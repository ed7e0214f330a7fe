"""State-space & recurrent blocks: Mamba2 (SSD, chunkwise), xLSTM (mLSTM /
sLSTM), as in the JAX package's ``repro.models.ssm``.

Chunkwise scans (Mamba2 and mLSTM): within a chunk the recurrence is
unrolled as small matmuls, across chunks a loop carries the O(1) state;
sLSTM steps token by token. States are float32. Each chunk body (each
sLSTM step) is rematerialized (``layers.remat``): only the carried state
is kept between chunks for the backward. Each ``*_decode`` is one
step of the recurrence and returns the new state; the caller stores it
into the cache.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import Init, _dense_init, matmul, remat

Tensor = torch.Tensor


def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# =============================== Mamba2 (SSD) ===================================
def init_mamba2(init: Init, d_model: int, ssm, dtype) -> dict:
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    return {
        # fused in-projection: [z (gate), x, B, C, dt]
        "w_in": _dense_init(
            init, (d_model, 2 * d_inner + 2 * ssm.d_state + n_heads), dtype),
        "w_out": _dense_init(init, (d_inner, d_model), dtype),
        "a_log": init.zeros((n_heads,), torch.float32),
        "dt_bias": init.full((n_heads,), -2.0, torch.float32),
        "d_skip": init.full((n_heads,), 1.0, torch.float32),
    }


def _ssd_chunk_scan(xh, bmat, cmat, dt, a, chunk):
    """Chunkwise SSD: xh (B,S,H,P), bmat/cmat (B,S,N), dt (B,S,H) fp32,
    a (H,) fp32 negative. Returns y (B,S,H,P)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    xc = xh.reshape(b, nc, chunk, h, p)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, h)

    # per-chunk cumulative log decay  (B,nc,chunk,H)
    cum = torch.cumsum(dtc * a[None, None, None, :], dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))

    def chunk_body(state, xcb, bcb, ccb, dtb, cumb):
        # intra-chunk (triangular) term
        li = cumb[:, :, None, :] - cumb[:, None, :, :]      # (B,c,c,H)
        gamma = torch.where(causal[None, :, :, None], torch.exp(li), 0.0)
        sc = torch.einsum("bqn,bkn->bqk", ccb, bcb)
        att = sc[:, :, :, None] * gamma * dtb[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", att, xcb)
        # inter-chunk: contribution of carried state
        decay_in = torch.exp(cumb)                          # (B,c,H)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", ccb, state, decay_in)
        # state update
        decay_out = torch.exp(cumb[:, -1:, :] - cumb)       # (B,c,H)
        upd = torch.einsum("bkn,bkhp,bkh,bkh->bhpn", bcb, xcb, dtb,
                           decay_out)
        state = state * torch.exp(cumb[:, -1, :])[:, :, None, None] + upd
        return state, y

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        # remat: the (B, c, c, H) intra-chunk decay and attention tensors
        # are recomputed in the backward
        state, y = remat(chunk_body, state, xc[:, c], bc[:, c], cc[:, c],
                         dtc[:, c], cum[:, c])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, h, p)


def _mamba2_inproj(params, x, ssm, d_model):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    n = ssm.d_state
    zxbcdt = matmul(x, params["w_in"])
    z, xs, bmat, cmat, dt = torch.split(
        zxbcdt, [d_inner, d_inner, n, n, n_heads], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])          # (B,S,H)
    a = -torch.exp(params["a_log"])                         # (H,) negative
    return z, xs, bmat.float(), cmat.float(), dt, a, n_heads, d_inner


def mamba2_train(params: dict, x: Tensor, ssm, d_model: int) -> Tensor:
    b, s, _ = x.shape
    z, xs, bmat, cmat, dt, a, n_heads, d_inner = _mamba2_inproj(
        params, x, ssm, d_model)
    xh = xs.reshape(b, s, n_heads, ssm.head_dim).float()
    chunk = min(ssm.chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by the SSD chunk {chunk}")
    y = _ssd_chunk_scan(xh, bmat, cmat, dt, a, chunk)
    y = y + params["d_skip"][None, None, :, None] * xh
    y = (y.reshape(b, s, d_inner) * F.silu(z.float())).to(x.dtype)
    return matmul(y, params["w_out"])


def mamba2_decode(params: dict, state: Tensor, x: Tensor, ssm,
                  d_model: int) -> tuple:
    """One-step recurrence. state: (B, H, P, N) fp32. x: (B, 1, D)."""
    b = x.shape[0]
    z, xs, bmat, cmat, dt, a, n_heads, d_inner = _mamba2_inproj(
        params, x, ssm, d_model)
    xh = xs.reshape(b, n_heads, ssm.head_dim).float()
    dt1 = dt[:, 0]                                          # (B,H)
    decay = torch.exp(dt1 * a[None, :])                     # (B,H)
    upd = torch.einsum("bn,bhp,bh->bhpn", bmat[:, 0], xh, dt1)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], state)
    y = y + params["d_skip"][None, :, None] * xh
    y = (y.reshape(b, 1, d_inner) * F.silu(z.float())).to(x.dtype)
    return matmul(y, params["w_out"]), state


def mamba2_state_shape(batch: int, d_model: int, ssm) -> tuple:
    d_inner = ssm.expand * d_model
    h = d_inner // ssm.head_dim
    return (batch, h, ssm.head_dim, ssm.d_state)


# ================================ xLSTM: mLSTM ==================================
def init_mlstm(init: Init, d_model: int, n_heads: int, dtype) -> dict:
    return {
        "wqkv": _dense_init(init, (d_model, 3 * d_model), dtype),
        "wif": _dense_init(init, (d_model, 2 * n_heads), dtype, scale=0.02),
        "wo_gate": _dense_init(init, (d_model, d_model), dtype),
        "wo": _dense_init(init, (d_model, d_model), dtype),
    }


def mlstm_train(params: dict, x: Tensor, n_heads: int,
                chunk: int = 256) -> Tensor:
    """Chunkwise mLSTM (matrix memory + exponential gating, xLSTM paper),
    stabilized: within a chunk the pairwise decay matrix is built from
    cumulative log-gates, with a running max ``m``."""
    b, s, d = x.shape
    dh = d // n_heads
    qkv = matmul(x, params["wqkv"])
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(b, s, n_heads, dh).float() / np.sqrt(dh)
    k = k.reshape(b, s, n_heads, dh).float()
    v = v.reshape(b, s, n_heads, dh).float()
    gif = matmul(x, params["wif"]).float()
    ig = gif[..., :n_heads]                                  # (B,S,H) log-ish
    fg = F.logsigmoid(gif[..., n_heads:] + 1.0)              # (B,S,H) <= 0

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by the mLSTM chunk {chunk}")
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, n_heads, dh)
    kc = k.reshape(b, nc, chunk, n_heads, dh)
    vc = v.reshape(b, nc, chunk, n_heads, dh)
    ic = ig.reshape(b, nc, chunk, n_heads)
    cumf = torch.cumsum(fg.reshape(b, nc, chunk, n_heads), dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))


    def chunk_body(cstate, nstate, mstate, qb, kb, vb, ib, cfb):
        # log weights of source k at target q within chunk
        lw = cfb[:, :, None, :] - cfb[:, None, :, :] + ib[:, None, :, :]
        lw = torch.where(causal[None, :, :, None], lw, -torch.inf)
        # carried-state log weight at each target
        lw_state = cfb + mstate[:, None, :]                  # (B,c,H)
        m_new = torch.maximum(lw.amax(dim=2), lw_state)      # (B,c,H)
        wmat = torch.exp(lw - m_new[:, :, None, :])
        wstate = torch.exp(lw_state - m_new)
        scores = torch.einsum("bqhd,bkhd->bqkh", qb, kb) * wmat
        num = torch.einsum("bqkh,bkhd->bqhd", scores, vb)
        num = num + wstate[..., None] * torch.einsum(
            "bqhd,bhde->bqhe", qb, cstate)
        den = scores.sum(2) + wstate * torch.einsum(
            "bqhd,bhd->bqh", qb, nstate)
        y = num / torch.clamp(den.abs(), min=1.0)[..., None]
        # state update to end of chunk
        lw_out = cfb[:, -1:, :] - cfb + ib                   # (B,c,H)
        m_up = torch.maximum(lw_out.amax(dim=1),
                             cfb[:, -1, :] + mstate)         # (B,H)
        wout = torch.exp(lw_out - m_up[:, None, :])
        wcarry = torch.exp(cfb[:, -1, :] + mstate - m_up)
        cstate = wcarry[:, :, None, None] * cstate + torch.einsum(
            "bkh,bkhd,bkhe->bhde", wout, kb, vb)
        nstate = wcarry[..., None] * nstate + torch.einsum(
            "bkh,bkhd->bhd", wout, kb)
        return cstate, nstate, m_up, y

    cstate = torch.zeros((b, n_heads, dh, dh), dtype=torch.float32,
                         device=x.device)
    nstate = torch.zeros((b, n_heads, dh), dtype=torch.float32,
                         device=x.device)
    mstate = torch.full((b, n_heads), -1e30, dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(nc):
        cstate, nstate, mstate, y = remat(
            chunk_body, cstate, nstate, mstate, qc[:, c], kc[:, c],
            vc[:, c], ic[:, c], cumf[:, c])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    y = y * F.silu(matmul(x, params["wo_gate"]))
    return matmul(y, params["wo"])


def mlstm_decode(params: dict, state: tuple, x: Tensor,
                 n_heads: int) -> tuple:
    """One-step mLSTM. state = (C (B,H,dh,dh), n (B,H,dh), m (B,H)) fp32."""
    b, _, d = x.shape
    dh = d // n_heads
    cstate, nstate, mstate = state
    qkv = matmul(x, params["wqkv"])
    q, k, v = qkv.chunk(3, dim=-1)
    q = q.reshape(b, n_heads, dh).float() / np.sqrt(dh)
    k = k.reshape(b, n_heads, dh).float()
    v = v.reshape(b, n_heads, dh).float()
    gif = matmul(x, params["wif"]).float()[:, 0]
    ig, fg = gif[:, :n_heads], F.logsigmoid(gif[:, n_heads:] + 1.0)
    m_new = torch.maximum(fg + mstate, ig)
    wf = torch.exp(fg + mstate - m_new)
    wi = torch.exp(ig - m_new)
    cstate = wf[:, :, None, None] * cstate + wi[:, :, None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    nstate = wf[..., None] * nstate + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, cstate)
    den = torch.einsum("bhd,bhd->bh", q, nstate)
    y = (num / torch.clamp(den.abs(), min=1.0)[..., None]).reshape(b, 1, d)
    y = y.to(x.dtype) * F.silu(matmul(x, params["wo_gate"]))
    return matmul(y, params["wo"]), (cstate, nstate, m_new)


def mlstm_state_shape(batch: int, d_model: int, n_heads: int) -> tuple:
    dh = d_model // n_heads
    return ((batch, n_heads, dh, dh), (batch, n_heads, dh), (batch, n_heads))


# ================================ xLSTM: sLSTM ==================================
def init_slstm(init: Init, d_model: int, n_heads: int, dtype) -> dict:
    dh = d_model // n_heads
    return {
        "w_gates": _dense_init(init, (d_model, 4 * d_model), dtype),
        # block-diagonal recurrent weights, per head: (H, dh, 4*dh)
        "r_gates": _dense_init(init, (n_heads, dh, 4 * dh), dtype,
                               scale=1.0 / np.sqrt(dh)),
        "wo": _dense_init(init, (d_model, d_model), dtype),
    }


def _slstm_step(params, carry, xg):
    """carry: (c, n, h, m), each (B, H, dh) fp32."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hde->bhe", h, params["r_gates"].float())
    g = xg + rec                                             # (B,H,4*dh)
    zt, it, ft, ot = g.chunk(4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lf = F.logsigmoid(ft + 1.0)
    m_new = torch.maximum(lf + m, it)
    wf, wi = torch.exp(lf + m - m_new), torch.exp(it - m_new)
    c = wf * c + wi * zt
    n = wf * n + wi
    h = ot * c / torch.clamp(n.abs(), min=1.0)
    return (c, n, h, m_new)


def slstm_train(params: dict, x: Tensor, n_heads: int) -> Tensor:
    b, s, d = x.shape
    dh = d // n_heads
    xg = matmul(x, params["w_gates"]).float().reshape(b, s, n_heads, 4 * dh)
    z = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=x.device)
    carry = (z, z, z, torch.full((b, n_heads, dh), -1e30,
                                 dtype=torch.float32, device=x.device))
    hs = []
    for t in range(s):
        carry = remat(_slstm_step, params, carry, xg[:, t])
        hs.append(carry[2])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return matmul(y, params["wo"])


def slstm_decode(params: dict, state: tuple, x: Tensor,
                 n_heads: int) -> tuple:
    b, _, d = x.shape
    dh = d // n_heads
    xg = matmul(x, params["w_gates"]).float().reshape(b, n_heads, 4 * dh)
    state = _slstm_step(params, state, xg)
    y = state[2].reshape(b, 1, d).to(x.dtype)
    return matmul(y, params["wo"]), state


def slstm_state_shape(batch: int, d_model: int, n_heads: int) -> tuple:
    dh = d_model // n_heads
    s = (batch, n_heads, dh)
    return (s, s, s, s)
