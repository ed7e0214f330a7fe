"""Iterative Charted Refinement — the paper's core algorithm (§4, Alg. 1).

``ICR`` is a generative representation of a GP: it applies an O(N)
approximate square root of the kernel matrix to a standard-normal
excitation ξ (paper §3.2),

    s = sqrt(K_ICR)(ξ)  with  <s sᵀ> ≈ K_XX.

``apply_sqrt_T`` applies the transpose, the second half of one inference
evaluation ("two applications of the square root and its VJP", paper §1).
Both are differentiable in ξ on every route; ``apply_sqrt`` also in θ
through ``matrices(theta)`` on every route (on the kernel route N-D levels
then take ``nd-axes``, and the pyramid's backward replays its levels
through the per-level kernels).

ξ is a list of tensors, one per level:
  ξ[0]: (prod(shape0),)           — exact coarse-grid excitation
  ξ[l]: (F_l, n_fsz^d), l=1..L    — per-family fine corrections
with a leading sample dim on every level for the batched entry points.

With ``use_pallas=True`` the chart's first levels run as one launch of
the pyramid kernel (``use_pyramid``, the default, as in the JAX package;
``dispatch.pyramid_cover`` says how many) and every other level on its
kernel route (``repro_torch.kernels.dispatch``); otherwise everything
runs on the plain torch path with the joint matrices. Tensors live on
``device`` (``"cuda"`` by default).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.policy import cast_tree, resolve, tree_leaves

from .charts import Chart
from .kernels import Kernel
from .refine import (
    LevelGeom,
    axis_refinement_matrices_level,
    level0_sqrt,
    refine_level,
    refine_level_T,
    refinement_matrices_level,
)

# captured transposes an instance keeps (each graph holds its own memory
# pool, about one chain's intermediates)
SQRT_T_GRAPHS = 4


@dataclasses.dataclass(frozen=True)
class ICR:
    """Iterative Charted Refinement model over `chart` with `kernel`.

    ``dtype_policy``: ``None`` keeps everything float32; ``"bf16"`` (or a
    ``DtypePolicy``) stores fields, ξ and matrices in bfloat16 with f32
    accumulation. ``use_pallas`` selects the kernel route.
    ``use_pyramid`` (with ``use_pallas``): run the chart's first levels,
    as many as ``dispatch.pyramid_cover`` covers, as ONE launch of the
    pyramid kernel; the remaining levels run one by one.
    """

    chart: Chart
    kernel: Kernel
    jitter: float = 1e-6
    use_pallas: bool = False
    dtype_policy: object = None
    use_pyramid: bool = True
    device: str = "cuda"

    @property
    def policy(self):
        """The resolved DtypePolicy (fp32 when ``dtype_policy`` is None)."""
        return resolve(self.dtype_policy)

    # -- shapes ---------------------------------------------------------------
    def xi_shapes(self) -> List[tuple]:
        nd = self.chart.ndim
        shapes = [(int(np.prod(self.chart.shape0)),)]
        for lvl in range(self.chart.n_levels):
            t = tuple(self.chart.family_count(lvl, a) for a in range(nd))
            shapes.append((int(np.prod(t)), self.chart.n_fsz**nd))
        return shapes

    def xi_size(self) -> int:
        return sum(int(np.prod(s)) for s in self.xi_shapes())

    @property
    def out_shape(self) -> tuple:
        return self.chart.final_shape

    # -- excitations ------------------------------------------------------------
    def init_xi(self, gen: torch.Generator | None = None, dtype=None, *,
                batch: int | None = None) -> List[torch.Tensor]:
        """Standard-normal excitations drawn from `gen` (a generator on
        ``device``); ``batch`` prepends a sample dim to every level.
        ``dtype`` defaults to the policy's storage dtype."""
        dtype = self.policy.storage_dtype if dtype is None else dtype
        lead = () if batch is None else (batch,)
        return [torch.randn(lead + s, generator=gen, device=self.device,
                            dtype=torch.float32).to(dtype)
                for s in self.xi_shapes()]

    def zero_xi(self, dtype=None) -> List[torch.Tensor]:
        dtype = self.policy.storage_dtype if dtype is None else dtype
        return [torch.zeros(s, dtype=dtype, device=self.device)
                for s in self.xi_shapes()]

    # -- matrices (functions of theta) ----------------------------------------
    def matrices(self, theta: Mapping | None = None, *,
                 joint: bool | None = None, axes: bool | None = None,
                 dtype=torch.float32) -> dict:
        """Refinement matrices for kernel parameters θ (paper Eq. 7/8).

        ``axes`` adds the per-axis Kronecker factors of the N-D kernel
        route (default: ``use_pallas`` on an N-D chart); ``joint`` builds
        the joint per-level matrices (default: exactly when the factors are
        not built — a joint N-D build is ``n_csz^{3d}`` per family). The
        math runs in `dtype` (float32; float64 gives a reference on the
        plain versions); a float32 result is cast to the storage dtype.
        """
        build_axes = (self.use_pallas and self.chart.ndim > 1
                      if axes is None else axes)
        build_joint = (not build_axes) if joint is None else joint
        k = self.kernel(theta)
        kw = dict(jitter=self.jitter, device=self.device, dtype=dtype)
        out = {"sqrt0": level0_sqrt(self.chart, k, **kw)}
        levels = range(self.chart.n_levels)
        if build_joint:
            pairs = [refinement_matrices_level(self.chart, k, lvl, **kw)
                     for lvl in levels]
            out["R"] = [p[0] for p in pairs]
            out["sqrtD"] = [p[1] for p in pairs]
        if build_axes:
            pairs = [axis_refinement_matrices_level(self.chart, k, lvl, **kw)
                     for lvl in levels]
            out["Rax"] = [p[0] for p in pairs]
            out["sqrtDax"] = [p[1] for p in pairs]
        pol = self.policy
        if dtype == torch.float32 and pol.storage_dtype != torch.float32:
            out = pol.cast_storage(out)
        return out

    @staticmethod
    def _theta_key(theta: Mapping | None):
        """Hashable fingerprint of θ."""
        if theta is None:
            return ()
        items = []
        for name in sorted(theta):
            v = theta[name]
            a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            items.append((name, a.dtype.str, a.shape, a.tobytes()))
        return tuple(items)

    def matrices_cached(self, theta: Mapping | None = None, *,
                        joint: bool | None = None,
                        axes: bool | None = None) -> dict:
        """``matrices()`` behind a per-instance LRU cache keyed on θ (the
        instance pins chart, dtype policy and device). Hits return the
        same dict: treat it as read-only."""
        key = (self._theta_key(theta), joint, axes)
        cache = self.__dict__.get("_mats_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_mats_cache", cache)
            object.__setattr__(self, "matrices_cache_stats",
                               {"hits": 0, "misses": 0})
        hit = cache.pop(key, None)
        if hit is not None:
            self.matrices_cache_stats["hits"] += 1
            cache[key] = hit  # re-insert: LRU order
            return hit
        self.matrices_cache_stats["misses"] += 1
        out = cache[key] = self.matrices(theta, joint=joint, axes=axes)
        while len(cache) > 8:  # bound: don't pin every historical θ's mats
            cache.pop(next(iter(cache)))
        return out

    # -- forward --------------------------------------------------------------
    def _refine_levels(self, mats: dict, xi: Sequence[torch.Tensor],
                       field: torch.Tensor) -> torch.Tensor:
        """Every refinement level on a batch of fields (S, *shape0)."""
        if not self.use_pallas:
            for lvl in range(self.chart.n_levels):
                geom = LevelGeom.for_level(self.chart, lvl)
                r, d = mats["R"][lvl], mats["sqrtD"][lvl]
                field = torch.stack([refine_level(f, x, r, d, geom)
                                     for f, x in zip(field, xi[lvl + 1])])
            return field

        from repro_torch.kernels import dispatch, pyramid

        pol = self.policy if self.dtype_policy is not None else None
        if pol is not None:
            field = field.to(pol.storage_dtype)
        start = 0
        cover = (dispatch.pyramid_cover(
            self.chart, samples=field.shape[0],
            itemsize=field.element_size())
            if self.use_pyramid else None)
        if cover is not None:
            start = cover
            geoms = [LevelGeom.for_level(self.chart, lvl)
                     for lvl in range(cover)]
            field = pyramid.refine_pyramid(
                field, xi[1:cover + 1],
                [_pyramid_mats(mats, g, lvl) for lvl, g in enumerate(geoms)],
                geoms, sample_axis=True, policy=pol)
        for lvl in range(start, self.chart.n_levels):
            geom = LevelGeom.for_level(self.chart, lvl)
            r, d, axis_mats = _level_mats(mats, lvl)
            field = dispatch.refine(field, xi[lvl + 1], r, d, geom,
                                    axis_mats=axis_mats, sample_axis=True,
                                    policy=pol)
        return field

    def apply_sqrt(self, mats: dict,
                   xi: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply sqrt(K_ICR) to ξ (paper Alg. 1); the finest field."""
        return self.apply_sqrt_batch(mats, [x[None] for x in xi])[0]

    def apply_sqrt_batch(self, mats: dict,
                         xi: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply sqrt(K_ICR) to a batch of excitations: ξ with a leading
        sample dim S on every level -> (S, *final_shape). On the kernel
        route the sample dim runs inside the kernels."""
        n_s = xi[0].shape[0]
        field = torch.matmul(xi[0], mats["sqrt0"].T).reshape(
            (n_s,) + self.chart.shape0)
        return self._refine_levels(mats, xi, field)

    def sample_batch(self, gen: torch.Generator | None, n: int, theta=None,
                     dtype=None) -> torch.Tensor:
        """Draw ``n`` approximate GP samples in one batched application —
        (n, *final_shape)."""
        return self.apply_sqrt_batch(self.matrices(theta),
                                     self.init_xi(gen, dtype, batch=n))

    def apply_sqrt_T(self, mats: dict, v: torch.Tensor) -> List[torch.Tensor]:
        """Apply sqrt(K_ICR)ᵀ to a field-space vector (paper §3.2, Eq. 3):
        v (*final_shape) -> ξ-shaped list (see ``xi_shapes``)."""
        return [x[0] for x in self.apply_sqrt_T_batch(mats, v[None])]

    def apply_sqrt_T_batch(self, mats: dict, v: torch.Tensor, *,
                           cached: bool = True) -> List[torch.Tensor]:
        """The transpose on a batch, v (S, *final_shape) -> ξ-shaped list
        with a leading S. ``apply_sqrt`` is linear in ξ at fixed matrices,
        so this is its VJP; on the kernel route it runs the adjoint
        kernels level by level, finest first, then ``sqrt0ᵀ``, without the
        forward pass an autograd VJP would run. Over the pyramid's levels
        that chain is the pyramid's transpose: its backward at fixed
        matrices runs the same adjoint kernels. That route is a transpose
        at fixed matrices: its inputs must not require grad (differentiate
        ``apply_sqrt`` instead).

        On the kernel route with CUDA tensors the chain is one captured
        CUDA graph, cached per instance as the JAX package caches its
        jitted transpose: keyed on v's shape, the storage dtype and the
        identity and version of every matrix tensor (the entry holds the
        tensors, so new or modified matrices never replay stale
        addresses), at most ``SQRT_T_GRAPHS`` graphs, least recently used
        first out. A call copies v into the graph's input, replays, and
        returns copies of its outputs. Inside another capture (a CG
        segment) the chain is recorded into that graph instead, and
        ``cached=False`` (a one-off call, for which a graph would keep a
        memory pool for nothing: the conditioning system's matvecs
        outside a segment, its dense matrix, its projections) or
        ``graphs.eager()`` runs it op by op."""
        from . import graphs

        if self.use_pallas:
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in [v, *tree_leaves(mats)]):
                raise NotImplementedError(
                    "apply_sqrt_T on the kernel route is not "
                    "differentiable; differentiate apply_sqrt instead")
            if (cached and v.is_cuda and not graphs.eager_mode()
                    and not torch.cuda.is_current_stream_capturing()):
                return self._apply_sqrt_T_graph(mats, v)
        return self._apply_sqrt_T_chain(mats, v)

    def _apply_sqrt_T_graph(self, mats: dict,
                            v: torch.Tensor) -> List[torch.Tensor]:
        """``_apply_sqrt_T_chain`` as a replay of its cached graph."""
        from . import graphs

        leaves = tree_leaves(mats)
        dtype = mats["sqrt0"].dtype
        key = (tuple(v.shape), dtype, str(v.device),
               tuple((id(t), t._version) for t in leaves))
        cache = self.__dict__.get("_sqrt_T_graphs")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_sqrt_T_graphs", cache)

        def make():
            buf = torch.empty(v.shape, dtype=dtype, device=v.device)
            buf.copy_(v)
            return (graphs.capture(
                lambda b: self._apply_sqrt_T_chain(mats, b), buf,
                device=v.device), leaves)

        with torch.no_grad():
            replay, _ = graphs.lru(cache, key, make, SQRT_T_GRAPHS)
            return [x.clone() for x in replay(v)]

    def _apply_sqrt_T_chain(self, mats: dict,
                            v: torch.Tensor) -> List[torch.Tensor]:
        """The transpose, op by op (see ``apply_sqrt_T_batch``)."""
        n_s = v.shape[0]
        g = v.to(mats["sqrt0"].dtype)
        xi = [None] * (self.chart.n_levels + 1)
        if self.use_pallas:
            from repro_torch.kernels import dispatch

            pol = self.policy if self.dtype_policy is not None else None
            for lvl in reversed(range(self.chart.n_levels)):
                geom = LevelGeom.for_level(self.chart, lvl)
                r, d, axis_mats = _level_mats(mats, lvl)
                g, xi[lvl + 1] = dispatch.refine_T(
                    g, r, d, geom, axis_mats=axis_mats, policy=pol)
        else:
            for lvl in reversed(range(self.chart.n_levels)):
                geom = LevelGeom.for_level(self.chart, lvl)
                r, d = mats["R"][lvl], mats["sqrtD"][lvl]
                parts = [refine_level_T(x, r, d, geom) for x in g]
                g = torch.stack([p[0] for p in parts])
                xi[lvl + 1] = torch.stack([p[1] for p in parts])
        xi[0] = torch.matmul(g.reshape(n_s, -1), mats["sqrt0"])
        return xi

    def __call__(self, xi: Sequence[torch.Tensor],
                 theta: Mapping | None = None) -> torch.Tensor:
        """The finest field for excitations ξ at kernel parameters θ:
        ``apply_sqrt(matrices(theta), xi)``, differentiable in ξ, and in θ
        where the route allows (see the module docstring)."""
        return self.apply_sqrt(self.matrices(theta), xi)

    def sample(self, gen: torch.Generator | None = None, theta=None,
               dtype=None) -> torch.Tensor:
        """Draw one approximate GP sample (paper Alg. 1; dtype defaults to
        the policy's storage dtype)."""
        return self(self.init_xi(gen, dtype), theta)

    # -- diagnostics ----------------------------------------------------------
    def implicit_sqrt(self, theta=None,
                      dtype=torch.float32) -> torch.Tensor:
        """Dense sqrt(K_ICR) as an (N, n_xi) matrix: the map is linear in
        ξ, so it is the batched apply of the identity basis, with the
        matrices built in `dtype` (float32 for the kernels; float64 gives
        the reference on the plain versions). Small N only."""
        mats = cast_tree(self.matrices(theta, dtype=dtype), dtype)
        n_xi = self.xi_size()
        eye = torch.eye(n_xi, dtype=dtype, device=self.device)
        xs, o = [], 0
        for s in self.xi_shapes():
            n = int(np.prod(s))
            xs.append(eye[:, o : o + n].reshape((n_xi,) + s))
            o += n
        return self.apply_sqrt_batch(mats, xs).reshape(n_xi, -1).T

    def implicit_cov(self, theta=None, dtype=torch.float32) -> torch.Tensor:
        """Dense K_ICR = sqrt(K_ICR) sqrt(K_ICR)ᵀ (paper Fig. 3)."""
        a = self.implicit_sqrt(theta, dtype)
        return a @ a.T


def _pyramid_mats(mats: dict, geom: LevelGeom, lvl: int) -> tuple:
    """(rs, ds) per-axis factors of level `lvl` for the pyramid: the N-D
    Kronecker factors, or a 1-D chart's joint matrices in its route's
    shapes (shared (n_fsz, n_csz), or per family (T, n_fsz, n_csz))."""
    if "Rax" in mats:
        return mats["Rax"][lvl], mats["sqrtDax"][lvl]
    lead = (geom.T[0],) if geom.kept_T[0] > 1 else ()
    return ([mats["R"][lvl].reshape(lead + (geom.n_fsz, geom.n_csz))],
            [mats["sqrtD"][lvl].reshape(lead + (geom.n_fsz,) * 2)])


def _level_mats(mats: dict, lvl: int) -> tuple:
    """(R, sqrtD, per-axis factors or None) of level `lvl`; each absent
    kind is None."""
    axis_mats = ((mats["Rax"][lvl], mats["sqrtDax"][lvl])
                 if "Rax" in mats else None)
    return (mats["R"][lvl] if "R" in mats else None,
            mats["sqrtD"][lvl] if "sqrtD" in mats else None, axis_mats)
