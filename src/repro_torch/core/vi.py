"""Inference over the standardized model (paper §3.2, Eq. 3).

The joint is ``log p(y, ξ) = log p(y | s(ξ)) - ||ξ||²/2 + const``. Because
``s(ξ) = sqrt(K_ICR)(ξ)``, its value and gradient never invert the kernel
matrix, the paper's central point. On the kernel route
(``ICR(use_pallas=True)``) every gradient runs the adjoint kernels.

* ``map_fit`` — MAP over ξ (the mode of Eq. 3), or over (ξ, θ) jointly;
* ``advi_fit`` — mean-field Gaussian VI with the reparametrization trick.
  Its Monte Carlo draws are a leading sample axis of ξ, so through
  ``ICR.apply_sqrt_batch`` they ride inside the kernels, forward and
  backward;
* ``cg_posterior`` — the exact Gaussian-likelihood posterior mean by
  guarded batched CG (``repro_torch.solvers``), each matvec one ``Sᵀ``
  and one ``S`` on the kernel route.

Both take any likelihood. ξ is a tensor, or a list, tuple or dict of them
(dicts in sorted key order, as the JAX package's pytrees).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.policy import tree_leaves
from repro_torch.optim import adamw, linear_warmup_cosine

Tree = Any


def _tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))


def _sqnorm(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))


def _trainable(tree):
    return _tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


def _detached(tree):
    return _tree_map(lambda x: x.detach(), tree)


def neg_log_joint(log_likelihood: Callable, forward: Callable):
    """-log p(y, ξ) up to a constant (paper Eq. 3)."""

    def loss(xi, y):
        return -log_likelihood(y, forward(xi)) + 0.5 * _sqnorm(xi)

    return loss


def _fit_step(loss_fn, params, steps: int, lr: float) -> tuple:
    """``(step, losses)``: one fit step over the tree `params` (the loss,
    its gradient, AdamW in place, the loss written into ``losses`` at the
    next index) and the (steps,) float32 buffer it writes."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    opt = adamw(linear_warmup_cosine(lr, steps // 10 + 1, steps),
                weight_decay=0.0)
    losses = torch.zeros(steps, dtype=torch.float32, device=device)
    at = torch.zeros(1, dtype=torch.int64, device=device)

    def step():
        loss = loss_fn(params)
        opt.update(torch.autograd.grad(loss, leaves), leaves)
        losses.index_copy_(0, at, loss.detach().float().reshape(1))
        at.add_(1)

    return step, losses


def _fit(loss_fn, params, steps: int, lr: float, *, jit: bool = True,
         draw: Callable[[], None] | None = None) -> torch.Tensor:
    """``steps`` AdamW steps on the tree `params` in place; the losses
    before each step, a float32 device tensor (steps,).

    One step is the loss, ``torch.autograd.grad`` through it (on the kernel
    route the adjoint kernels) and AdamW in place; it writes its loss into
    a preallocated buffer at a device index, so no step reads the host.
    `draw`, if given, runs before each step, outside it (ADVI's ε into
    static buffers). With ``jit`` on a CUDA device the step is captured
    once as a CUDA graph (``core/graphs.capture``) and replayed: the
    capture's eager warm-up is the real step 0, and replays 1 to
    ``steps - 1`` follow. A capture that fails raises; it never falls back
    to eager steps. CPU tensors run the same step eagerly."""
    from repro_torch.core import graphs

    step, losses = _fit_step(loss_fn, params, steps, lr)
    device = losses.device
    run = step
    for i in range(steps):
        if draw is not None:
            draw()
        if i == 0 and jit:
            try:
                run = graphs.capture(step, device=device)
            except RuntimeError as exc:
                raise RuntimeError(
                    "map_fit/advi_fit(jit=True): the step could not be "
                    "captured as one CUDA graph. A forward that rebuilds "
                    "the matrices from a learned θ syncs with the host "
                    "(torch.linalg's eigh); pass jit=False for it (ROADMAP "
                    "queue 1, item 2: the learned-θ build on the card). "
                    f"The capture said: {exc}") from exc
            if run.graph is not None:
                continue  # the capture's warm-up was step 0
        run()
    return losses


def map_fit(log_likelihood, forward, xi0: Tree, y, steps: int = 300,
            lr: float = 3e-2, jit: bool = True):
    """MAP estimate of ξ (deterministic). Returns ``(xi_hat, losses)``,
    losses (steps,) taken before each update.

    ``jit=True`` is the JAX package's compiled scan: on a CUDA device one
    step is captured as a CUDA graph and replayed (``_fit``); the forward
    must then not sync with the host, so a forward that learns θ
    (rebuilding the matrices, whose eigh syncs) raises and takes
    ``jit=False``, which runs the same step op by op."""
    loss_fn = neg_log_joint(log_likelihood, forward)
    xi = _trainable(xi0)
    losses = _fit(lambda p: loss_fn(p, y), xi, steps, lr, jit=jit)
    return _detached(xi), losses


def advi_fit(gen: torch.Generator, log_likelihood, forward, xi0: Tree, y,
             steps: int = 300, lr: float = 2e-2, n_mc: int = 2):
    """Mean-field ADVI over ξ with the closed-form Gaussian KL.

    ``forward`` maps ξ with a leading axis of ``n_mc`` draws on every leaf
    to ``n_mc`` fields (``lambda xi: icr.apply_sqrt_batch(mats, xi)``);
    the draws come from `gen`. Returns ``((mean, log_std), elbos)``; a
    sample is ``mean + exp(log_std) * eps``.

    Compiled on a CUDA device as the JAX package's scan is (``_fit``): ε
    is drawn from `gen` into static buffers before each replay, leaf by
    leaf, so the fit equals the eager one (inside ``graphs.eager()``)
    bit for bit from the same generator state.
    """
    mean = _trainable(xi0)
    log_std = _tree_map(
        lambda x: torch.full_like(x, -2.0).requires_grad_(True), xi0)
    eps = _tree_map(lambda m: torch.empty((n_mc,) + m.shape,
                                          device=m.device,
                                          dtype=torch.float32), xi0)

    def draw():
        _tree_map(lambda e: e.normal_(generator=gen), eps)

    def loss_fn(params):
        mean, log_std = params
        xi = _tree_map(lambda m, ls, e: m + torch.exp(ls) * e.to(m.dtype),
                       mean, log_std, eps)
        fields = forward(xi)
        ll = torch.stack([log_likelihood(y, f) for f in fields]).mean()
        kl = sum(torch.sum(0.5 * (torch.exp(2 * ls.float())
                                  + torch.square(m.float()) - 1.0)
                           - ls.float())
                 for m, ls in zip(tree_leaves(mean), tree_leaves(log_std)))
        return -(ll - kl)

    losses = _fit(loss_fn, (mean, log_std), steps, lr, draw=draw)
    return (_detached(mean), _detached(log_std)), -losses


# -- posterior export ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Posterior:
    """A fitted GP posterior: mean-field Gaussian ``q(ξ)`` plus θ.

    ``mean`` is a ξ-shaped list; ``log_std`` is ξ-shaped too, or None for
    a MAP fit's delta posterior (every draw is ξ̂ and the predictive std is
    zero). A field draw is ``sqrt(K_ICR)(mean + exp(log_std)·ε)``, one
    batched application of the square root for all draws.
    """

    icr: Any
    mean: list
    log_std: list | None = None
    theta: Any = None

    def matrices(self) -> dict:
        """The (cached) refinement matrices at the fitted θ."""
        return self.icr.matrices_cached(self.theta)

    def std(self) -> list:
        """Per-level excitation std (zeros for a MAP delta posterior)."""
        if self.log_std is None:
            return [torch.zeros_like(m) for m in self.mean]
        return [torch.exp(ls) for ls in self.log_std]

    def sample_xi(self, gen: torch.Generator | None, n: int) -> list:
        """n ξ draws from q, sample dim leading (``apply_sqrt_batch``'s
        layout)."""
        if self.log_std is None:
            return [m.expand((n,) + m.shape) for m in self.mean]
        return [m[None] + torch.exp(ls)[None] * torch.randn(
                    (n,) + m.shape, generator=gen, device=m.device,
                    dtype=torch.float32).to(m.dtype)
                for m, ls in zip(self.mean, self.log_std)]

    def sample_fields(self, gen: torch.Generator | None, n: int):
        """n posterior field draws, (n, *final_shape)."""
        return self.icr.apply_sqrt_batch(self.matrices(),
                                         self.sample_xi(gen, n))

    def moments(self, gen: torch.Generator | None, n: int) -> tuple:
        """Monte Carlo predictive mean and std over n draws."""
        f = self.sample_fields(gen, n).float()
        return f.mean(0), f.std(0, correction=0)


def map_posterior(icr, xi_hat, theta=None) -> Posterior:
    """A MAP fit (``map_fit``'s ξ̂) as a delta Posterior."""
    return Posterior(icr=icr, mean=list(xi_hat), theta=theta)


def advi_posterior(icr, params, theta=None) -> Posterior:
    """An ADVI fit (``advi_fit``'s ``(mean, log_std)``) as a Posterior."""
    mean, log_std = params
    return Posterior(icr=icr, mean=list(mean), log_std=list(log_std),
                     theta=theta)


def cg_posterior(icr, obs, y, *, noise_std: float = 0.05, theta=None,
                 config=None, use_precond: bool = True,
                 dense_fallback: bool = True, mesh=None, manager=None,
                 checkpoint_every: int = 0, _solution=None) -> tuple:
    """Exact data-conditioned posterior via guarded batched CG.

    Solves ``(W K Wᵀ + σ²I) α = y`` matrix-free (the covariance acts
    through two ICR square-root applications per matvec), then whitens
    the correction: ``ξ̂ = Sᵀ Wᵀ α``, so the returned delta
    :class:`Posterior` (``mean = ξ̂``, ``log_std = None``) reproduces the
    exact GP regression posterior mean ``K Wᵀ α`` through the ordinary
    sampling path (``sqrt(K)(ξ̂)``).

    ``obs`` is an observation spec: flat finest-grid indices (any
    dimension), off-grid 1-D locations (a float array: KISS-GP sparse
    interpolation rows), or a prebuilt operator from
    ``solvers.gp_system``. Without a ``config`` the solve runs at
    ``ConditionSystem.default_config``: the JAX package's rtol 1e-7, and
    on float32 matrices a tolerance that rises to the matvec's rounding
    at each column's own iterate (``CGConfig.floor_cap``; 1e-7 lies under
    float32's floor on large systems); the report records rtol, the cap
    and δ. The
    iterations replay captured CUDA graphs on the card
    (``solvers/pcg.py``). The solve runs the fallback ladder
    (ICR-whitened preconditioner → unpreconditioned → dense for small
    systems) with per-RHS quarantine isolation; ``manager`` +
    ``checkpoint_every`` opt into checkpointing. ``mesh`` is not ported
    yet and raises (``build_condition_system``).

    Returns ``(posterior, report)``, the report the structured
    :class:`~repro_torch.solvers.SolveReport`. A dict passed as
    ``_solution`` receives the solve's ``system``, ``alpha`` and ``cfg``
    (for a caller that checks α's residual without solving again).
    """
    import numpy as np

    from repro_torch.solvers import build_condition_system, solve_guarded
    from repro_torch.solvers.gp_system import obs_operator

    if hasattr(obs, "apply") and hasattr(obs, "apply_t"):
        op = obs
    else:
        arr = (obs.cpu().numpy() if isinstance(obs, torch.Tensor)
               else np.asarray(obs))
        if np.issubdtype(arr.dtype, np.integer):
            op = obs_operator(icr, obs_idx=arr)
        else:
            op = obs_operator(icr, x_obs=arr)
    y = torch.as_tensor(y, dtype=torch.float32,
                        device=icr.device).reshape(1, -1)
    if y.shape[1] != op.n_obs:
        raise ValueError(f"y has {y.shape[1]} entries but the observation "
                         f"operator expects {op.n_obs}")
    system = build_condition_system(icr, op, float(noise_std) ** 2,
                                    theta=theta, mesh=mesh,
                                    use_precond=use_precond)
    cfg = system.default_config() if config is None else config
    ladder = ([("icr", system.precond)] if system.precond is not None
              else []) + [("none", None)]
    alpha, report = solve_guarded(
        system.matvec, y, preconds=ladder,
        dense_solve=system.dense_solve if dense_fallback else None,
        cfg=cfg, manager=manager, checkpoint_every=checkpoint_every,
        tag="cg_posterior", segment_graphs=system.graphs)
    if _solution is not None:
        _solution.update(system=system, alpha=alpha, cfg=cfg)
    xi_hat = system.project_xi(alpha)
    mean = [leaf[0] for leaf in xi_hat]
    return Posterior(icr=icr, mean=mean, theta=theta), report


def gaussian_log_likelihood(noise_std: float, obs_idx=None):
    """Gaussian likelihood on the field, or on its flat entries
    ``obs_idx``."""

    def ll(y, s):
        pred = s.reshape(-1) if obs_idx is None else s.reshape(-1)[obs_idx]
        return -0.5 * torch.sum(torch.square((y - pred) / noise_std))

    return ll


def poisson_log_likelihood(obs_idx=None):
    """Poisson counts with log-rate = field: a non-Gaussian likelihood
    (the 'arbitrary likelihood' of paper §3.2)."""

    def ll(y, s):
        lam = s.reshape(-1) if obs_idx is None else s.reshape(-1)[obs_idx]
        return torch.sum(y * lam - torch.exp(lam) - torch.lgamma(y + 1.0))

    return ll
