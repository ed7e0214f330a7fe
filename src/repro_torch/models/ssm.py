"""State-space & recurrent blocks: Mamba2 (SSD, chunkwise), xLSTM (mLSTM /
sLSTM), as in the JAX package's ``repro.models.ssm``.

Chunkwise scans (Mamba2 and mLSTM): within a chunk the recurrence is
unrolled as small matmuls, across chunks a loop carries the O(1) state;
sLSTM steps token by token. States are float32. Each chunk body (each
sLSTM step) is rematerialized (``layers.remat``): only the carried state
is kept between chunks for the backward. Each ``*_decode`` is one
step of the recurrence and returns the new state; the caller stores it
into the cache.

On a bound mesh (``shard_ctx``) each model slot computes a tile of the
state: Mamba2 its heads (or, where they do not divide the model axis,
its channels of every head: the dim ``cache_specs`` splits), from its
columns of ``w_in`` (B and C whole) and rows of ``w_out``; mLSTM its heads
(or its block of q·k's dim, C's split), the numerators and denominators
combined over the slots before the output gate and the row-parallel
``wo``; sLSTM its columns of ``w_gates`` and rows of ``wo``, around a
recurrence that runs replicated. A decode step reads and writes the
state's blocks in place where they are its tiles. Where no split divides,
the mixer runs replicated.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import Init, _dense_init, dot_f32, matmul, remat
from .shard_ctx import columns, executor, replicate, rows

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


def _mamba2_inproj(params, x, nh: int, hp: int, n: int):
    """z, x, B, C, dt (softplus) and a of `nh` heads of `hp` channels:
    ``w_in`` holds their columns ``[z | x | B | C | dt]``."""
    zxbcdt = matmul(x, params["w_in"])
    z, xs, bmat, cmat, dt = torch.split(
        zxbcdt, [nh * hp, nh * hp, n, n, nh], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])          # (B,S,H)
    a = -torch.exp(params["a_log"])                         # (H,) negative
    return z, xs, bmat.float(), cmat.float(), dt, a


def _mamba2_y(params, x, nh: int, hp: int, n: int, chunk: int) -> Tensor:
    """The gated SSD output (B, S, nh·hp) in x's dtype, before ``w_out``."""
    b, s, _ = x.shape
    z, xs, bmat, cmat, dt, a = _mamba2_inproj(params, x, nh, hp, n)
    xh = xs.reshape(b, s, nh, hp).float()
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by the SSD chunk {chunk}")
    y = _ssd_chunk_scan(xh, bmat, cmat, dt, a, chunk)
    y = y + params["d_skip"][None, None, :, None] * xh
    return (y.reshape(b, s, nh * hp) * F.silu(z.float())).to(x.dtype)


def _mamba2_dims(ssm, d_model: int) -> tuple:
    """(heads, channels per head, state size)."""
    return ssm.expand * d_model // ssm.head_dim, ssm.head_dim, ssm.d_state


def mamba2_train(params: dict, x: Tensor, ssm, d_model: int) -> Tensor:
    h, p, n = _mamba2_dims(ssm, d_model)
    ex = executor()
    if ex is not None:
        tile = _tiles(ex, h, p)
        if tile is not None:
            def slot(m, dev, xs):
                hs, ps = tile(m)
                local = _mamba2_local(ex, params, hs, ps, h, p, n, dev)
                y = _mamba2_y(local, xs, _len(hs), _len(ps), n, ssm.chunk)
                return dot_f32(y, local["w_out"])

            return ex.row_parallel(slot, (x,), x.dtype)
        params = ex.replicate_tree(params)     # neither split divides
    return matmul(_mamba2_y(params, x, h, p, n, ssm.chunk), params["w_out"])


def _mamba2_step(params, state: Tensor, x: Tensor, nh: int, hp: int,
                 n: int) -> tuple:
    """One step of `nh` heads of `hp` channels: (gated y (B, 1, nh·hp) in
    x's dtype, new state (B, nh, hp, N) fp32)."""
    b = x.shape[0]
    z, xs, bmat, cmat, dt, a = _mamba2_inproj(params, x, nh, hp, n)
    xh = xs.reshape(b, nh, hp).float()
    dt1 = dt[:, 0]                                          # (B,H)
    decay = torch.exp(dt1 * a[None, :])                     # (B,H)
    upd = torch.einsum("bn,bhp,bh->bhpn", bmat[:, 0], xh, dt1)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], state)
    y = y + params["d_skip"][None, :, None] * xh
    return (y.reshape(b, 1, nh * hp) * F.silu(z.float())).to(x.dtype), state


def mamba2_decode(params: dict, state, x: Tensor, ssm,
                  d_model: int) -> tuple:
    """One-step recurrence. state: (B, H, P, N) fp32. x: (B, 1, D). On a
    bound mesh the state is a cache leaf (``_mamba2_decode_mesh``)."""
    h, p, n = _mamba2_dims(ssm, d_model)
    ex = executor()
    if ex is not None:
        if state.mdim in (1, 2) and state.ddim in (None, 0,
                                                    3 - state.mdim):
            return _mamba2_decode_mesh(ex, params, state, x, h, p, n), state
        # neither the heads nor the head dim split: replicated
        params, state = ex.replicate_tree(params), ex.gather_leaf(state)
    y, state = _mamba2_step(params, state, x, h, p, n)
    return matmul(y, params["w_out"]), state


def _mamba2_decode_mesh(ex, params, state, x, h, p, n) -> Tensor:
    """Each slot steps the tile of heads × channels its block of the state
    holds (``cache_specs`` splits the channels, or the heads), in place
    once every slot has read (the data indices of a replicated batch may
    share a block), from its tile's columns of ``w_in`` (B and C whole) and rows of
    ``w_out``; the float32 partials summed over the slots (and over the
    data indices where the data axes split the tiles)."""
    writes = []      # after every slot has read: data indices may share

    def slot(m, dev, xs):
        region, blk = ex.slot_block(state)
        hs, ps = region[1], region[2]
        local = _mamba2_local(ex, params, hs, ps, h, p, n, dev)
        y, new = _mamba2_step(local, blk, xs, _len(hs), _len(ps), n)
        writes.append((blk, new))
        return dot_f32(y, local["w_out"])

    def total(parts):
        acc = parts[0]
        for t in parts[1:]:
            acc = acc + t
        return acc

    split = state.ddim in (1, 2)
    out = ex.per_slot(slot, (x,), total, total if split else None)
    for blk, new in writes:
        blk.copy_(new)
    ex.count("all_reduce", ex.M * out.numel() * 4, over=ex.M, per_line=True)
    if split and ex.line is None:
        ex.count("all_reduce", ex.S * out.numel() * 4, over=ex.D)
    return out.to(x.dtype)


def _len(sl: slice) -> int:
    return sl.stop - sl.start


def _tiles(ex, h: int, p: int, by: str | None = None):
    """Model slot m's tile ``(heads, channels)`` of an (h, p) state, by
    heads or by channels (`by`, where that split divides the model axis;
    by default the heads where they divide it, else the channels); None
    where it does not divide. The tile function's ``by`` says which."""
    def block(m, size):
        k = size // ex.M
        return slice(m * k, (m + 1) * k)

    if by is None:
        by = "heads" if h % ex.M == 0 else "channels"
    if by == "heads" and h % ex.M == 0:
        tile = lambda m: (block(m, h), slice(0, p))
    elif by == "channels" and p % ex.M == 0:
        tile = lambda m: (slice(0, h), block(m, p))
    else:
        return None
    tile.by = by
    return tile


def _tile_runs(hs: slice, ps: slice, p: int) -> tuple:
    """The runs of a (heads, channels) tile in a head-major (h · p) dim."""
    if _len(ps) == p:
        return ((hs.start * p, _len(hs) * p),)
    return tuple((i * p + ps.start, _len(ps)) for i in range(hs.start,
                                                              hs.stop))


def _mamba2_local(ex, params, hs, ps, h, p, n, dev) -> dict:
    """A slot's Mamba2 weights for its tile: its z and x columns of
    ``w_in`` with B, C whole and its heads' dt, its rows of ``w_out``, its
    heads' ``a_log``, ``dt_bias``, ``d_skip``."""
    di = h * p
    tile = _tile_runs(hs, ps, p)
    cols = tile + tuple((di + s, k) for s, k in tile) + (
        (2 * di, 2 * n), (2 * di + 2 * n + hs.start, _len(hs)))
    local = {"w_in": ex.take(params["w_in"], 1, cols, dev),
             "w_out": ex.take(params["w_out"], 0, tile, dev)}
    for k in ("a_log", "dt_bias", "d_skip"):
        local[k] = params[k][hs].to(dev)
    return local


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


def _mlstm_inputs(params, x, nh: int, dk: int, dv: int, dh: int) -> tuple:
    """q (scaled by the head dim `dh`), k (B, S, nh, dk), v (B, S, nh, dv)
    float32 and the input and log forget gates (B, S, nh): ``wqkv`` holds
    the columns ``[q | k | v]``, ``wif`` ``[i | f]``."""
    b, s, _ = x.shape
    q, k, v = torch.split(matmul(x, params["wqkv"]),
                          [nh * dk, nh * dk, nh * dv], dim=-1)
    q = q.reshape(b, s, nh, dk).float() / np.sqrt(dh)
    k = k.reshape(b, s, nh, dk).float()
    v = v.reshape(b, s, nh, dv).float()
    gif = matmul(x, params["wif"]).float()
    return q, k, v, gif[..., :nh], F.logsigmoid(gif[..., nh:] + 1.0)


def _mlstm_scan(q, k, v, ig, fg, chunk: int) -> tuple:
    """Chunkwise mLSTM (matrix memory + exponential gating, xLSTM paper),
    stabilized: within a chunk the pairwise decay matrix is built from
    cumulative log-gates, with a running max ``m``. Returns the numerator
    (B, S, H, dv) and denominator (B, S, H) of the output; both are sums
    over q·k's dim, so a slot holding part of it gives partials."""
    b, s, nh, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by the mLSTM chunk {chunk}")
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, nh, dk)
    kc = k.reshape(b, nc, chunk, nh, dk)
    vc = v.reshape(b, nc, chunk, nh, dv)
    ic = ig.reshape(b, nc, chunk, nh)
    cumf = torch.cumsum(fg.reshape(b, nc, chunk, nh), dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))

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
        return cstate, nstate, m_up, num, den

    cstate = torch.zeros((b, nh, dk, dv), dtype=torch.float32,
                         device=q.device)
    nstate = torch.zeros((b, nh, dk), dtype=torch.float32, device=q.device)
    mstate = torch.full((b, nh), -1e30, dtype=torch.float32,
                        device=q.device)
    nums, dens = [], []
    for c in range(nc):
        cstate, nstate, mstate, num, den = remat(
            chunk_body, cstate, nstate, mstate, qc[:, c], kc[:, c],
            vc[:, c], ic[:, c], cumf[:, c])
        nums.append(num)
        dens.append(den)
    return (torch.stack(nums, dim=1).reshape(b, s, nh, dv),
            torch.stack(dens, dim=1).reshape(b, s, nh))


def _mlstm_norm(num: Tensor, den: Tensor, x: Tensor) -> Tensor:
    """The output ``num / max(|den|, 1)`` as (B, S, D) in x's dtype."""
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return y.reshape(x.shape).to(x.dtype)


def _mlstm_out(params, y: Tensor, x: Tensor) -> Tensor:
    """``(y · silu(x @ wo_gate)) @ wo``: row-parallel on a bound mesh,
    slot m's columns of ``wo_gate`` and rows of ``wo``."""
    ex = executor()
    if ex is None or x.shape[-1] % ex.M:
        return rows(y * F.silu(matmul(x, params["wo_gate"])), params["wo"])
    size = x.shape[-1] // ex.M
    return ex.row_parallel(lambda m, dev, ys, xs: dot_f32(
        ys[..., m * size:(m + 1) * size]
        * F.silu(matmul(xs, ex.part(params["wo_gate"], 1, m, dev))),
        ex.part(params["wo"], 0, m, dev)), (y, x), x.dtype)


def mlstm_train(params: dict, x: Tensor, n_heads: int,
                chunk: int = 256) -> Tensor:
    """Chunkwise mLSTM (``_mlstm_scan``). On a bound mesh each model slot
    scans its heads, or where they do not divide the model axis its block
    of q·k's dim (``cache_specs``' split of C), the partial numerators
    and denominators summed over the slots."""
    d = x.shape[-1]
    dh = d // n_heads
    ex = executor()
    if ex is not None:
        tile = _tiles(ex, n_heads, dh) if d % ex.M == 0 else None
        if tile is not None:
            def slot(m, dev, xs):
                hs, ds = tile(m)
                local = _mlstm_local(ex, params, hs, ds, n_heads, dh, dev)
                return _mlstm_scan(*_mlstm_inputs(
                    local, xs, _len(hs), _len(ds), dh, dh), chunk)

            num, den = _mlstm_combine(ex, ex.per_slot(
                slot, (x,), lambda line: line), tile.by == "heads")
            return _mlstm_out(params, _mlstm_norm(num, den, x), x)
        params = ex.replicate_tree(params)     # neither split divides
    num, den = _mlstm_scan(*_mlstm_inputs(params, x, n_heads, dh, dh, dh),
                           chunk)
    return _mlstm_out(params, _mlstm_norm(num, den, x), x)


def _mlstm_local(ex, params, hs, ds, n_heads, dh, dev) -> dict:
    """A slot's mLSTM weights for its (heads, q·k dim) tile: its q and k
    columns of ``wqkv``, its heads' v columns, its heads' gates."""
    d = n_heads * dh
    qk = _tile_runs(hs, ds, dh)
    v = _tile_runs(hs, slice(0, dh), dh)
    cols = qk + tuple((d + s, k) for s, k in qk) + tuple(
        (2 * d + s, k) for s, k in v)
    gates = ((hs.start, _len(hs)), (n_heads + hs.start, _len(hs)))
    return {"wqkv": ex.take(params["wqkv"], 1, cols, dev),
            "wif": ex.take(params["wif"], 1, gates, dev)}


def _mlstm_combine(ex, line: list, heads: bool) -> tuple:
    """The slots' (num, den) combined on the line's device: concatenated
    where they hold heads (an all-gather), summed where they hold parts of
    q·k's dim (an all-reduce)."""
    num, den = line[0][0], line[0][1]
    if heads:
        num = torch.cat([p[0] for p in line], dim=-2)
        den = torch.cat([p[1] for p in line], dim=-1)
        ex.count("all_gather", ex.M * 4 * (num.numel() + den.numel())
                 * ex.D, over=ex.M)
        return num, den
    for p in line[1:]:
        num, den = num + p[0], den + p[1]
    ex.count("all_reduce", ex.M * 4 * (num.numel() + den.numel()),
             over=ex.M, per_line=True)
    return num, den


def _mlstm_step(q, k, v, ig, fg, cstate, nstate, mstate) -> tuple:
    """One mLSTM step: q, k (B, H, dk), v (B, H, dv), gates (B, H), states
    (B, H, dk, dv), (B, H, dk), (B, H) fp32 -> (num (B, H, dv), den (B, H),
    new states)."""
    m_new = torch.maximum(fg + mstate, ig)
    wf = torch.exp(fg + mstate - m_new)
    wi = torch.exp(ig - m_new)
    cstate = wf[:, :, None, None] * cstate + wi[:, :, None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    nstate = wf[..., None] * nstate + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, cstate)
    den = torch.einsum("bhd,bhd->bh", q, nstate)
    return num, den, (cstate, nstate, m_new)


def mlstm_decode(params: dict, state: tuple, x: Tensor,
                 n_heads: int) -> tuple:
    """One-step mLSTM. state = (C (B,H,dh,dh), n (B,H,dh), m (B,H)) fp32.
    On a bound mesh the state's leaves are cache leaves
    (``_mlstm_decode_mesh``)."""
    d = x.shape[-1]
    dh = d // n_heads
    ex = executor()
    if ex is not None:
        c = state[0]
        # the tiles C's blocks are, where they are tiles; else the train's
        by = {1: "heads", 2: "channels"}.get(c.mdim) \
            if c.ddim in (None, 0) else None
        tile = _tiles(ex, n_heads, dh, by) if d % ex.M == 0 else None
        if tile is not None:
            return _mlstm_decode_mesh(ex, params, state, x, n_heads, dh,
                                      tile)
        params = ex.replicate_tree(params)     # neither split divides
        state = tuple(ex.gather_leaf(s) for s in state)
    q, k, v, ig, fg = (t[:, 0] for t in _mlstm_inputs(
        params, x, n_heads, dh, dh, dh))
    num, den, state = _mlstm_step(q, k, v, ig, fg, *state)
    return _mlstm_out(params, _mlstm_norm(num[:, None], den[:, None], x),
                      x), state


def _mlstm_decode_mesh(ex, params, state, x, n_heads, dh, tile) -> tuple:
    """Each slot steps its (heads, q·k dim) tile; a state leaf whose blocks
    are the tiles (C where ``cache_specs`` splits it on that dim) is read
    and written in place (once every slot has read), another is gathered
    whole, sliced per slot and its new value written back into its
    blocks."""
    heads = tile.by == "heads"
    # the dim of each leaf the tiles split (m: none where q·k's dim is)
    need = (1, 1, 1) if heads else (2, 2, None)
    inplace = [s.mdim == k and s.ddim in (None, 0)
               for s, k in zip(state, need)]
    wholes = [ex.gather_leaf(s) for s, ok in zip(state, inplace) if not ok]

    def cut(t, k, hs, ds):
        if k is None:
            return t
        return t.narrow(k, *((hs.start, _len(hs)) if k == 1
                             else (ds.start, _len(ds))))

    def slot(m, dev, xs, *whole):
        hs, ds = tile(m)
        local = _mlstm_local(ex, params, hs, ds, n_heads, dh, dev)
        q, k, v, ig, fg = (t[:, 0] for t in _mlstm_inputs(
            local, xs, _len(hs), _len(ds), dh, dh))
        it, cur = iter(whole), []
        for s, k_, ok in zip(state, need, inplace):
            cur.append(ex.slot_block(s)[1] if ok
                       else cut(next(it), k_, hs, ds))
        num, den, new = _mlstm_step(q, k, v, ig, fg, *cur)
        writes.extend((t, n_) for t, n_, ok in zip(cur, new, inplace) if ok)
        return (num[:, None], den[:, None]) + tuple(
            n_ for n_, ok in zip(new, inplace) if not ok)

    writes = []      # after every slot has read: data indices may share
    line = ex.per_slot(slot, (x, *wholes), lambda line: line)
    for t, new in writes:
        t.copy_(new)
    num, den = _mlstm_combine(ex, [p[:2] for p in line], heads)
    out = _mlstm_out(params, _mlstm_norm(num, den, x), x)
    news, i = [], 2
    for s, k, ok in zip(state, need, inplace):
        if ok:
            news.append(s)
            continue
        parts = [p[i] for p in line]
        news.append(parts[0] if k is None else torch.cat(parts, dim=k))
        i += 1
    return out, tuple(news)


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
    """sLSTM token by token. On a bound mesh the input projection is
    column-parallel and ``wo`` row-parallel; the block-diagonal recurrence
    runs replicated on the line's device (``r_gates`` gathered: splitting
    it would gather h over the slots at every token)."""
    b, s, d = x.shape
    dh = d // n_heads
    xg = columns(matmul, x, params["w_gates"]).float().reshape(
        b, s, n_heads, 4 * dh)
    rec = {"r_gates": replicate(params["r_gates"])}
    z = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=x.device)
    carry = (z, z, z, torch.full((b, n_heads, dh), -1e30,
                                 dtype=torch.float32, device=x.device))
    hs = []
    for t in range(s):
        carry = remat(_slstm_step, rec, carry, xg[:, t])
        hs.append(carry[2])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return rows(y, params["wo"])


def slstm_decode(params: dict, state: tuple, x: Tensor,
                 n_heads: int) -> tuple:
    """One sLSTM step; on a bound mesh its state, like its recurrence, is
    whole on the line's device (gathered, and written back by the
    caller)."""
    b, _, d = x.shape
    dh = d // n_heads
    ex = executor()
    if ex is not None:
        state = tuple(ex.gather_leaf(s) for s in state)
    xg = columns(matmul, x, params["w_gates"]).float().reshape(
        b, n_heads, 4 * dh)
    state = _slstm_step({"r_gates": replicate(params["r_gates"])}, state, xg)
    y = state[2].reshape(b, 1, d).to(x.dtype)
    return rows(y, params["wo"]), state


def slstm_state_shape(batch: int, d_model: int, n_heads: int) -> tuple:
    dh = d_model // n_heads
    s = (batch, n_heads, dh)
    return (s, s, s, s)
