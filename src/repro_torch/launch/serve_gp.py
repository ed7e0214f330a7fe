"""Batched GP posterior field server, on one device.

The counterpart of the JAX package's ``launch/serve_gp.py`` (its
single-device half). Clients submit posterior-sample and
predictive-moment requests against a fitted ICR posterior
(``core.vi.Posterior``: a MAP ξ̂ or a mean-field ``(mean, log_std)``),
and the server

  * packs heterogeneous requests into fixed-size **sample slabs**, each
    one ``ICR.apply_sqrt_batch`` on the kernel route;
  * computes predictive mean/std by **streaming Welford accumulation**
    over slabs (Chan's parallel merge per slab, in numpy);
  * never rebuilds structure for repeat traffic: the executable cache is
    keyed on (chart, kernel, jitter, θ, dtype policy, routing flags,
    device, slab) and each entry holds the matrices
    (``ICR.matrices_cached``), the plan (``dispatch.plan_cached``) and the
    slab executable.

On the card the slab executable is one captured CUDA graph
(``core.graphs.capture``), the port's counterpart of the JAX package's
jitted slab: it draws every row's excitation, runs the levels' kernels
(the pyramid's cooperative launch among them on a 1-D stationary chart)
and casts the fields to float32. A slab copies to the card only what
changes: the rows' seeds, row indices and ξ flags (a few hundred bytes),
and a request's own ξ rows when it supplies them. The posterior's
q-parameters live in the entry's static buffers and are ``copy_``d in on
``set_posterior``. On a CPU device (only when the caller asks for it, as
the tests do) the same slab function runs eagerly on the kernels' plain
versions.

**Per-row noise.** A row's excitation is ``mean + std · z`` (or the
request's own ξ in place of ``mean``), where ``z`` is a pure function of
(request seed, row index, position in the row's excitation), so a
request's draws do not depend on how rows were packed. The position
counts the levels' ξ in order (level ``l``, flat index ``i``: position
``offset_l + i``), so it stands for (level, flat index). The draw
(``row_noise_bits``, ``row_normals``) is counter-based, in int64 torch
ops with every product and sum masked to 32 bits, and captures into the
graph with no generator state:

  mix(x)      = a two-round xorshift-multiply finalizer of 32-bit x
                (shifts 15, 12, 15; odd multipliers 0x2c1b3c6d and
                0x297a2d39, both below 2³¹, so no int64 product overflows)
  k           = mix(mix(seed) ^ row)
  m, a        = mix(k ^ 0x9e3779b9) & 0x7fffffff | 1,  mix(k ^ 0x85ebca6b)
  bits[j, p]  = mix(((2p + j) · m mod 2³² + a) mod 2³²),  j = 0, 1
  u_j         = ((bits[j, p] >> 8) + 1) · 2⁻²⁴     (24-bit, in (0, 1])
  z[p]        = sqrt(-2 ln u_0) · cos(2π u_1)       (Box–Muller, float64,
                                                     rounded to float32)

Multiplying by an odd ``m`` is a bijection mod 2³², so no two counters
of one row share their input to the last ``mix``. Padding rows use row
``_PAD_ROW = 2**30``. The draws differ from the JAX package's threefry
``fold_in(PRNGKey(seed), row)`` by design, as ξ draws already do between
the packages; requests that bring their own ξ on a MAP posterior serve
identical fields from both servers.

**Data-conditioned requests** (``kind="condition"``): one per step, a
whole batched solve of the guarded CG (``repro_torch.solvers``) on the
served θ. Column 0 solves for the posterior mean; columns 1..n are
Matheron pathwise targets ``y − W f_j − σ ε_j`` for prior draws
``f_j = S ξ_j``, with ξ_j and ε_j from the same counter-based (seed, row)
stream (positions past the row's ξ give ε), so they differ from the JAX
package's threefry draws as the slabs' do. The predictive std is taken
over the columns that were not quarantined; the request's
``SolveReport`` rides back on it and in ``metrics()``.

Not ported yet: the mesh modes and the re-plan after a device loss (on
one device a ``DeviceLossError`` propagates, mid-solve too, as the JAX
server's does without a mesh), and ``lowered_slab``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_gp [--scenario dust]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.vi import Posterior
from repro_torch.distributed.fault import ServingFaultSupervisor
from repro_torch.kernels import dispatch

_PAD_ROW = 2**30  # padding rows index past every request's noise stream

_M32 = 0xFFFFFFFF
_MIX = (15, 0x2C1B3C6D, 12, 0x297A2D39, 15)
_KEY_MUL, _KEY_ADD = 0x9E3779B9, 0x85EBCA6B


# -- counter-based per-row noise ------------------------------------------------
def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer on int64 values in [0, 2³²), in place."""
    s1, c1, s2, c2, s3 = _MIX
    x.bitwise_xor_(x >> s1)
    x.mul_(c1).bitwise_and_(_M32)
    x.bitwise_xor_(x >> s2)
    x.mul_(c2).bitwise_and_(_M32)
    return x.bitwise_xor_(x >> s3)


def noise_counters(n: int, device) -> torch.Tensor:
    """The counters of a row of ``n`` excitation entries: (2, n) int64,
    ``[j, p] = 2p + j``."""
    if 2 * n > 2**32:
        raise ValueError(f"{n} excitation entries exceed the 32-bit counter")
    p = torch.arange(n, dtype=torch.int64, device=device)
    return torch.stack([2 * p, 2 * p + 1])


def row_noise_bits(seeds: torch.Tensor, rows: torch.Tensor,
                   counters: torch.Tensor) -> torch.Tensor:
    """The integer stream: (S, 2, n) int64 values in [0, 2³²) for seeds
    and rows (S,) int64 and ``noise_counters(n)`` (module docstring)."""
    k = _mix32(_mix32(seeds.to(torch.int64).clone()) ^ rows)
    mul = (_mix32(k ^ _KEY_MUL) & 0x7FFFFFFF) | 1
    add = _mix32(k ^ _KEY_ADD)
    x = counters[None] * mul[:, None, None]
    x.bitwise_and_(_M32).add_(add[:, None, None]).bitwise_and_(_M32)
    return _mix32(x)


def row_normals(seeds: torch.Tensor, rows: torch.Tensor,
                counters: torch.Tensor) -> torch.Tensor:
    """Standard normals (S, n) float32 from ``row_noise_bits`` by two
    24-bit uniforms in (0, 1] and Box–Muller, in float64 (float32 loses
    up to ~2e-6 in cos(2πu) times a radius up to 5.8), rounded once."""
    u = ((row_noise_bits(seeds, rows, counters) >> 8) + 1).double()
    u.mul_(2.0**-24)
    r = torch.log(u[:, 0]).mul_(-2.0).sqrt_()
    return r.mul_(torch.cos(u[:, 1].mul_(2.0 * math.pi))).float()


# -- requests -------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestError:
    """Structured per-request admission/serving error: truthy, with a
    stable machine-readable ``code`` and a message for humans."""

    code: str
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.message}"

    def __bool__(self) -> bool:
        return True


@dataclasses.dataclass
class GPRequest:
    """One client request against the served posterior.

    kind="sample": return ``n`` posterior field draws (in ``fields``).
    kind="moments": MC predictive mean/std over an ``n``-draw budget (in
    ``mean``/``std``; the draws are not retained).

    ``xi`` optionally replaces the posterior mean for this request's rows:
    leaf shapes must match the served chart's ``xi_shapes()`` and values
    must be finite, both checked at admission. ``theta`` optionally pins
    the hyperparameters the client expects; a mismatch is an admission
    error.

    kind="condition": the exact posterior mean given observed values
    ``y`` at exactly one of on-grid flat indices ``obs_idx`` or off-grid
    1-D locations ``x_obs``, with observation noise ``noise_std`` (σ), in
    ``mean``; ``std`` is the predictive std over ``n`` Matheron pathwise
    samples (n >= 2 for a non-trivial std); ``report`` the solve's
    ``SolveReport``.
    """

    kind: str
    n: int
    seed: int = 0
    xi: Optional[list] = None
    theta: Optional[dict] = None
    y: Optional[np.ndarray] = None
    obs_idx: Optional[np.ndarray] = None
    x_obs: Optional[np.ndarray] = None
    noise_std: float = 0.05
    done: bool = False
    error: Optional[object] = None  # RequestError
    fields: list = dataclasses.field(default_factory=list)
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None
    report: Optional[object] = None  # solvers.SolveReport (condition)
    # internal: rows drawn so far (the request's noise-stream index), the
    # streaming Welford state (count, running mean, running M2), and
    # whether admission already ran
    _next_row: int = 0
    _wcount: int = 0
    _wmean: Optional[np.ndarray] = None
    _wm2: Optional[np.ndarray] = None
    _admitted: bool = False


def _canonical_key(x) -> str:
    """Deterministic printable form of an executable-cache key component:
    functions by qualified name, bytes by a content hash, dataclasses
    (Chart, DtypePolicy) over their fields, so equal configs print (and
    digest) identically in any process."""
    if isinstance(x, tuple):
        return "(" + ",".join(_canonical_key(v) for v in x) + ")"
    if isinstance(x, bytes):
        return "bytes<sha256:" + hashlib.sha256(x).hexdigest()[:12] + ">"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fields = ",".join(f"{f.name}={_canonical_key(getattr(x, f.name))}"
                          for f in dataclasses.fields(x))
        return f"{type(x).__name__}({fields})"
    if callable(x) and hasattr(x, "__qualname__"):
        return f"fn:{getattr(x, '__module__', '?')}.{x.__qualname__}"
    return repr(x)


def _welford_merge(count, m, m2, batch: np.ndarray):
    """Chan et al. parallel merge of a k-sample batch into (count, m, m2)."""
    k = batch.shape[0]
    bm = batch.mean(axis=0)
    bm2 = ((batch - bm) ** 2).sum(axis=0)
    if count == 0:
        return k, bm, bm2
    tot = count + k
    delta = bm - m
    m = m + delta * (k / tot)
    m2 = m2 + bm2 + delta**2 * (count * k / tot)
    return tot, m, m2


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _all_finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x, np.float64)).all())


class GPFieldServer:
    """Continuous-batching server over one (swappable) fitted Posterior,
    on the posterior's device.

    ``slab`` is the fixed slab height: every step runs one fixed-shape
    batch of rows through the entry's slab executable (on the card, one
    replay of its CUDA graph). Rows go to queued requests greedily in
    queue order; a short slab pads with rows whose noise index lies past
    every request's stream.
    """

    def __init__(self, posterior: Posterior, slab: int = 8,
                 max_cached: int = 8,
                 supervisor: Optional[ServingFaultSupervisor] = None,
                 fault_injector: Optional[Callable] = None,
                 ckpt_root: Optional[str] = None,
                 solver_checkpoint_every: int = 8,
                 solver_config=None):
        self.slab = int(slab)
        self.supervisor = supervisor or ServingFaultSupervisor()
        # test hook: called once per slab attempt with the server; may
        # raise (a transient error, or DeviceLossError), sleep, or no-op
        self.fault_injector = fault_injector
        # (key -> entry) executable cache, LRU-bounded: a server re-fit at
        # many θ must not pin one matrices set and graph per θ forever
        self.max_cached = int(max_cached)
        self._exec: dict = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.graph_captures = 0
        self.slabs_run = 0
        self.slabs_attempted = 0  # execution attempts incl. retried ones
        self.rows_served = 0      # non-padding rows (posterior draws)
        self.fields_delivered = 0
        # data-conditioned solves (kind="condition")
        self.ckpt_root = ckpt_root
        self.solver_checkpoint_every = int(solver_checkpoint_every)
        self.solver_config = solver_config
        self.condition_requests = 0
        self.condition_rhs = 0       # real (unpadded) RHS columns solved
        self.solve_segments = 0      # CG segment attempts
        self.solve_reports: list = []  # the last few SolveReports
        self._cond_cache: dict = {}
        self._cond_seq = 0
        self.posterior = None
        self.set_posterior(posterior)

    @property
    def capacity(self) -> int:
        """Rows per executed slab: the slab height (one device)."""
        return self.slab

    @property
    def serving_mode(self) -> str:
        """``single:`` and how the active entry's slab runs:
        ``cuda-graph`` or ``cpu-eager``."""
        return self._entry["mode"]

    # -- executable cache ----------------------------------------------------
    def _cache_key(self, post: Posterior):
        icr = post.icr
        # the kernel is fingerprinted too: θ is often baked into its
        # defaults (with_defaults) with theta=None, and two such posteriors
        # must not collide on an equal chart
        kern = icr.kernel
        kkey = (kern.fn, kern.name,
                tuple(sorted((k, float(v))
                             for k, v in kern.default_theta.items())))
        return (icr.chart, kkey, icr.jitter, icr._theta_key(post.theta),
                icr.policy, icr.use_pallas, icr.use_pyramid,
                str(torch.device(icr.device)), self.slab)

    def _validate_posterior(self, post: Posterior):
        """A poisoned fit is never installed: non-finite θ or q-parameters
        would NaN every slab for every client."""
        for name, leaves in (("theta", list((post.theta or {}).values())),
                             ("mean", list(post.mean)),
                             ("std", list(post.std()))):
            for leaf in leaves:
                if not _all_finite(leaf):
                    raise ValueError(
                        f"posterior rejected: non-finite values in {name}")

    def set_posterior(self, post: Posterior):
        """Point the server at a (new) fit. An equal key is a cache hit:
        the matrices, plan and graph are reused and only the q-parameters
        are copied into the entry's buffers (the graph holds their
        addresses); anything else is a miss and builds a fresh entry."""
        self._validate_posterior(post)
        key = self._cache_key(post)
        if key in self._exec:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        entry = graphs.lru(self._exec, key, lambda: self._build(post),
                           self.max_cached)
        bufs = entry["bufs"]
        for off, n, m, s in zip(entry["offsets"], entry["sizes"], post.mean,
                                post.std()):
            bufs["mean"][off:off + n].copy_(m.reshape(-1))
            bufs["std"][off:off + n].copy_(s.reshape(-1))
        self.posterior = post
        self._entry = entry
        return entry

    def _build(self, post: Posterior) -> dict:
        icr = post.icr
        device = torch.device(icr.device)
        shapes = [tuple(s) for s in icr.xi_shapes()]
        sizes = [math.prod(s) for s in shapes]
        offsets = list(itertools.accumulate(sizes[:-1], initial=0))
        n_xi, cap = sum(sizes), self.capacity
        storage = icr.policy.storage_dtype
        plan = dispatch.plan_cached(
            icr.chart, samples=cap, dtype=storage,
            pyramid=icr.use_pallas and icr.use_pyramid, device=device)
        mats = icr.matrices_cached(post.theta)
        counters = noise_counters(n_xi, device)
        meta = torch.zeros((3, cap), dtype=torch.int64, device=device)
        meta[1] = _PAD_ROW
        bufs = {"meta": meta,  # seeds, rows, ξ flags
                "client": torch.zeros((cap, n_xi), device=device),
                "mean": torch.zeros(n_xi, device=device),
                "std": torch.zeros(n_xi, device=device)}

        def draw(meta, client, mean, std):
            """Each row's excitation: (seed, row)-keyed noise around the
            posterior mean, or around the request's own ξ."""
            z = row_normals(meta[0], meta[1], counters)
            base = torch.where(meta[2, :, None] != 0, client, mean)
            flat = torch.addcmul(base, std, z)
            return [flat[:, o:o + n].reshape((cap,) + s).to(storage)
                    .contiguous()
                    for o, n, s in zip(offsets, sizes, shapes)]

        def slab_fn(meta, client, mean, std):
            # clients get f32 fields whatever the storage dtype
            xi = draw(meta, client, mean, std)
            return icr.apply_sqrt_batch(mats, xi).float()

        args = (bufs["meta"], bufs["client"], bufs["mean"], bufs["std"])
        fn = graphs.capture(slab_fn, *args, device=device)
        if fn.graph is not None:
            self.graph_captures += 1
        mode = f"single:{device.type}-{'eager' if fn.graph is None else 'graph'}"
        return {"mats": mats, "plan": plan, "fn": fn, "slab_fn": slab_fn,
                "draw": draw, "args": args, "bufs": bufs,
                "capacity": cap, "shapes": shapes, "sizes": sizes,
                "offsets": offsets, "mode": mode}

    # -- admission -----------------------------------------------------------
    def _reject(self, req: GPRequest, code: str, message: str):
        req.error = RequestError(code=code, message=message)
        req.done = True

    def _admit(self, queue: List[GPRequest]):
        """Validate each request once, before any of its rows are packed:
        a rejected request never enters a slab, so it cannot poison the
        moments of the healthy requests packed beside it."""
        shapes = self.posterior.icr.xi_shapes()
        served_theta = dict(self.posterior.icr.kernel.default_theta)
        served_theta.update(self.posterior.theta or {})
        served_theta = {k: _host(v) for k, v in served_theta.items()}
        for req in queue:
            if req.done or req.error or req._admitted:
                continue
            req._admitted = True
            if req.kind not in ("sample", "moments", "condition") \
                    or not isinstance(req.n, (int, np.integer)) \
                    or req.n <= 0 or not 0 <= int(req.seed) < 2**31:
                self._reject(req, "bad-request",
                             f"kind={req.kind!r} n={req.n} seed={req.seed} "
                             "(seed must fit int32)")
                continue
            if req.theta is not None:
                bad = [k for k, v in req.theta.items()
                       if not _all_finite(v)]
                if bad:
                    self._reject(req, "theta-nonfinite",
                                 f"non-finite theta entries {bad}")
                    continue
                stale = [k for k, v in req.theta.items()
                         if k not in served_theta
                         or not np.allclose(served_theta[k], _host(v))]
                if stale:
                    self._reject(
                        req, "theta-mismatch",
                        f"request pinned theta {sorted(req.theta)} but the "
                        f"server is fitted at {sorted(served_theta)} with "
                        f"different values for {stale}")
                    continue
            if req.xi is not None:
                got = [tuple(np.shape(leaf)) for leaf in req.xi]
                want = [tuple(s) for s in shapes]
                if got != want:
                    self._reject(req, "xi-geometry",
                                 f"xi leaves {got} do not match the served "
                                 f"chart's xi_shapes() {want}")
                    continue
                if not all(_all_finite(leaf) for leaf in req.xi):
                    self._reject(req, "xi-nonfinite",
                                 "xi contains NaN/Inf values")
                    continue
            if req.kind == "condition":
                self._admit_condition(req)

    def _admit_condition(self, req: GPRequest):
        """Conditioning inputs are validated before any solve work runs:
        a non-finite y or a malformed observation spec is a structured
        rejection at the queue, while divergence or NaN *inside* the solve
        is the solver's quarantine's job; either way no other request's
        answer is perturbed. The codes are the JAX server's."""
        y = None if req.y is None else _host(req.y).astype(np.float64)
        if y is None or y.size == 0:
            return self._reject(req, "y-missing",
                                "kind='condition' requires observed "
                                "values y")
        y = y.ravel()
        if not np.isfinite(y).all():
            return self._reject(req, "y-nonfinite",
                                "y contains NaN/Inf values")
        if (req.obs_idx is None) == (req.x_obs is None):
            return self._reject(req, "obs-spec",
                                "pass exactly one of obs_idx (on-grid) "
                                "or x_obs (off-grid 1-D)")
        chart = self.posterior.icr.chart
        n_grid = int(np.prod(chart.final_shape))
        if req.obs_idx is not None:
            idx = (req.obs_idx.cpu().numpy()
                   if isinstance(req.obs_idx, torch.Tensor)
                   else np.asarray(req.obs_idx))
            if idx.size and not np.issubdtype(idx.dtype, np.integer):
                return self._reject(req, "obs-dtype",
                                    "obs_idx must be integer flat indices")
            if idx.size == 0 or idx.min() < 0 or idx.max() >= n_grid:
                return self._reject(req, "obs-range",
                                    "obs_idx empty or out of range for a "
                                    f"{n_grid}-pixel chart")
            n_obs = idx.size
        else:
            x = _host(req.x_obs).astype(np.float64).ravel()
            if chart.ndim != 1:
                return self._reject(req, "obs-ndim",
                                    "off-grid x_obs interpolation is 1-D "
                                    "only; use obs_idx for N-D charts")
            if x.size == 0 or not np.isfinite(x).all():
                return self._reject(req, "obs-nonfinite",
                                    "x_obs is empty or non-finite")
            n_obs = x.size
        if y.size != n_obs:
            return self._reject(req, "obs-length",
                                f"y has {y.size} entries but the "
                                f"observation spec has {n_obs}")
        if not (np.isfinite(req.noise_std) and float(req.noise_std) > 0):
            return self._reject(req, "noise-invalid",
                                f"noise_std={req.noise_std!r} must be a "
                                "finite positive float")

    # -- slab execution ------------------------------------------------------
    def _slab_args(self, entry: dict, rows: list) -> tuple:
        """One slab's inputs: each request's own ξ is written into its rows
        of the entry's buffer here; the seeds, rows and flags are returned
        as one host tensor, which the slab executable copies into its
        buffer. Rows past the packed prefix are padding."""
        cap = entry["capacity"]
        meta = np.zeros((3, cap), np.int64)
        meta[1] = _PAD_ROW
        i = 0
        while i < len(rows):  # contiguous runs per request
            req, j = rows[i][0], i
            while j < len(rows) and rows[j][0] is req:
                j += 1
            meta[0, i:j] = req.seed
            meta[1, i:j] = [r for _, r in rows[i:j]]
            if req.xi is not None:
                meta[2, i:j] = 1
                flat = np.concatenate([_host(leaf).astype(np.float32).ravel()
                                       for leaf in req.xi])
                entry["bufs"]["client"][i:j].copy_(
                    torch.from_numpy(flat).expand(j - i, -1))
            i = j
        return (torch.from_numpy(meta),)

    def _execute_once(self, entry: dict, args: tuple) -> np.ndarray:
        """One slab attempt under the fault supervisor: a transient error
        retries (the same graph, replayed again), ``DeviceLossError``
        propagates, wall time feeds the straggler monitor. The fields come
        back as float32 numpy (through pinned memory on the card)."""

        def attempt():
            self.slabs_attempted += 1
            if self.fault_injector is not None:
                self.fault_injector(self)
            out = entry["fn"](*args)
            if out.device.type != "cuda":
                return out.numpy()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()
            return host.numpy()

        return self.supervisor.execute(attempt)

    def _run_rows(self, rows: list) -> np.ndarray:
        """Execute one slab of packed rows (at most ``capacity``). On one
        device a ``DeviceLossError`` has nothing to re-plan onto and
        propagates."""
        entry = self._entry
        out = self._execute_once(entry, self._slab_args(entry, rows))
        self.slabs_run += 1
        return out[:len(rows)]

    # -- data-conditioned solves (kind="condition") ----------------------------
    def _condition_system(self, op, noise_var: float):
        """LRU-cached ConditionSystem keyed like the executable cache plus
        the observation fingerprint and σ²: a re-fit or a new observation
        pattern is a deliberate miss."""
        from repro_torch.solvers import build_condition_system

        post = self.posterior
        key = (self._cache_key(post), op.fingerprint(), float(noise_var))
        return graphs.lru(
            self._cond_cache, key,
            lambda: build_condition_system(post.icr, op, noise_var,
                                           theta=post.theta),
            self.max_cached)

    def _solver_manager(self):
        """Per-solve CheckpointManager under ``ckpt_root`` (lazily a
        temporary directory): every solve gets its own directory, so a
        resumed carry can never alias another request's checkpoints."""
        if self.solver_checkpoint_every <= 0:
            return None
        import os
        import tempfile

        from repro_torch.checkpoint import CheckpointManager

        if self.ckpt_root is None:
            self.ckpt_root = tempfile.mkdtemp(prefix="gp-serve-solve-")
        self._cond_seq += 1
        return CheckpointManager(
            os.path.join(self.ckpt_root, f"solve_{self._cond_seq}"))

    def _matheron_draws(self, req: GPRequest, n_obs: int, mats) -> tuple:
        """The request's prior draws: fields ``f_j = S ξ_j`` (n, N) in
        float32 and observation noise ``ε_j`` (n, n_obs), row j of the
        request's (seed, row) stream (ξ at the row's first positions, as
        a sampling slab draws them, ε after them)."""
        icr = self.posterior.icr
        device = torch.device(icr.device)
        shapes = [tuple(s) for s in icr.xi_shapes()]
        sizes = [math.prod(s) for s in shapes]
        n_xi, n = sum(sizes), int(req.n)
        z = row_normals(
            torch.full((n,), int(req.seed), dtype=torch.int64, device=device),
            torch.arange(n, dtype=torch.int64, device=device),
            noise_counters(n_xi + n_obs, device))
        storage = icr.policy.storage_dtype
        xi = [z[:, o:o + m].reshape((n,) + s).to(storage).contiguous()
              for o, m, s in zip(itertools.accumulate(sizes[:-1], initial=0),
                                 sizes, shapes)]
        with torch.no_grad():
            fields = icr.apply_sqrt_batch(mats, xi).float().reshape(n, -1)
        return fields, z[:, n_xi:]

    def _run_condition(self, req: GPRequest):
        """Serve one kind="condition" request end to end.

        RHS layout: column 0 solves the posterior-mean system
        ``(W K Wᵀ + σ²I) α = y``; columns 1..n are Matheron pathwise
        targets ``y − W f_j − σ ε_j`` (``_matheron_draws``). The solve runs
        the guarded fallback ladder under the fault supervisor, with
        checkpoints every ``solver_checkpoint_every`` iterations; the
        SolveReport rides back on the request and in ``metrics()``."""
        from repro_torch.solvers import solve_guarded
        from repro_torch.solvers.gp_system import obs_operator

        self.condition_requests += 1
        icr = self.posterior.icr
        try:
            op = obs_operator(
                icr, obs_idx=req.obs_idx,
                x_obs=None if req.x_obs is None else _host(req.x_obs))
        except ValueError as e:  # race-proofing: _admit already checks
            return self._reject(req, "obs-invalid", str(e))
        noise_std = float(req.noise_std)
        system = self._condition_system(op, noise_std ** 2)
        shape = tuple(icr.chart.final_shape)
        k_real = 1 + int(req.n)
        fields, eps = self._matheron_draws(req, op.n_obs, system.mats)
        y = torch.as_tensor(_host(req.y).astype(np.float32).ravel(),
                            device=fields.device)[None, :]
        b = torch.cat([y, y - op.apply(fields) - noise_std * eps], dim=0)

        def fault_hook(it):
            self.solve_segments += 1
            if self.fault_injector is not None:
                self.fault_injector(self)

        cfg = self.solver_config or system.default_config()
        ladder = ([("icr", system.precond)]
                  if system.precond is not None else []) + [("none", None)]
        alpha, report = solve_guarded(
            system.matvec, b, preconds=ladder, cfg=cfg,
            dense_solve=system.dense_solve,
            manager=self._solver_manager(),
            checkpoint_every=self.solver_checkpoint_every or None,
            fault_hook=fault_hook, executor=self.supervisor.execute,
            n_report=k_real, tag=f"condition:{op.n_obs}obs",
            segment_graphs=system.graphs)

        req.report = report
        self.solve_reports.append(report)
        del self.solve_reports[:-16]
        self.condition_rhs += k_real
        if report.status[0] not in ("converged", "dense"):
            req.done = True
            req.error = RequestError(
                "solve-failed",
                f"posterior-mean solve ended '{report.status[0]}' "
                f"(relres {report.relres[0]:.2e}) after rungs "
                f"{list(report.rungs)}")
            return
        with torch.no_grad():
            corr = system.correct(alpha[:k_real]).float().reshape(k_real, -1)
        req.mean = _host(corr[0]).reshape(shape)
        # predictive std over the *non-quarantined* Matheron samples: a
        # diverged/NaN sample column is excluded, never averaged in
        good = [j for j in range(1, k_real)
                if report.status[j] in ("converged", "dense")]
        if len(good) >= 2:
            sel = torch.tensor(good, device=corr.device)
            samples = fields[sel - 1] + corr[sel]
            req.std = _host(samples.std(dim=0, correction=0)).reshape(shape)
        else:
            req.std = np.zeros(shape, np.float32)
        self.fields_delivered += 2
        req.done = True

    # -- serving loop --------------------------------------------------------
    def step(self, queue: List[GPRequest]) -> bool:
        """Pack one slab from the queue, execute it, scatter the results.
        Condition requests are served one per step (a whole batched solve
        is one unit of work); sample and moments rows pack into slabs.
        Returns False when no request had demand (queue drained)."""
        self._admit(queue)
        for req in queue:
            if not req.done and req.kind == "condition":
                self._run_condition(req)
                return True
        cap = self._entry["capacity"]
        rows = []  # (request, row index in its noise stream)
        for req in queue:
            if req.done:
                continue
            take = min(req.n - req._next_row, cap - len(rows))
            rows.extend((req, req._next_row + j) for j in range(take))
            req._next_row += take
            if len(rows) == cap:
                break
        if not rows:
            return False
        out = self._run_rows(rows)
        self.rows_served += len(rows)
        i = 0
        while i < len(rows):
            req, j = rows[i][0], i
            while j < len(rows) and rows[j][0] is req:
                j += 1
            chunk = out[i:j]
            if req.kind == "sample":
                # copies, not views: a retained row must not pin the slab
                req.fields.extend(np.array(row) for row in chunk)
            else:
                req._wcount, req._wmean, req._wm2 = _welford_merge(
                    req._wcount, req._wmean, req._wm2, chunk)
            if req._next_row >= req.n:
                if req.kind == "moments":
                    req.mean = req._wmean
                    req.std = np.sqrt(np.maximum(req._wm2 / req._wcount, 0.0))
                    self.fields_delivered += 2
                else:
                    self.fields_delivered += len(req.fields)
                req.done = True
            i = j
        return True

    def run(self, requests: List[GPRequest], max_iters: int = 1_000_000):
        queue = list(requests)
        # re-resolve the entry for this batch: warm traffic against the
        # same key counts a hit and reuses everything
        self.set_posterior(self.posterior)
        it = 0
        while any(not r.done for r in queue) and it < max_iters:
            if not self.step(queue):
                break
            it += 1
        for r in queue:
            if not r.done:  # max_iters exhausted: signal, never silently
                r.error = RequestError(
                    code="max-iters",
                    message=f"server stopped after max_iters={max_iters} "
                            f"slabs with {r.n - r._next_row} rows pending")
                r.done = True
        return requests

    # -- introspection -------------------------------------------------------
    def modeled_slab_bytes(self) -> int:
        """Modeled device-memory bytes of one slab's levels (the plan's
        ``hbm_bytes`` at the slab height; the draw is not modeled)."""
        return sum(e["hbm_bytes"]["selected"] for e in self._entry["plan"])

    @property
    def route(self) -> str:
        """Route of the finest (dominant) refinement level."""
        return self._entry["plan"][-1]["route"]

    def metrics(self) -> dict:
        """Serving, solver and fault counters."""
        return {
            "slabs_run": self.slabs_run,
            "slabs_attempted": self.slabs_attempted,
            "rows_served": self.rows_served,
            "fields_delivered": self.fields_delivered,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cached_entries": len(self._exec),
            "graph_captures": self.graph_captures,
            "mode": self.serving_mode,
            "capacity": self.capacity,
            "condition_requests": self.condition_requests,
            "condition_rhs": self.condition_rhs,
            "solve_segments": self.solve_segments,
            "solve_fallbacks": sum(len(r.fallbacks)
                                   for r in self.solve_reports),
            "solve_resumes": sum(len(r.resumes)
                                 for r in self.solve_reports),
            "solve_reports": [r.summary() for r in self.solve_reports[-4:]],
            **{f"fault_{k}": v
               for k, v in self.supervisor.metrics().items()},
        }

    def cache_key_fingerprint(self) -> dict:
        """Deterministic printable fingerprint of the active cache key:
        equal server configs give byte-identical fingerprints in any
        process; anything that would miss changes the digest."""
        canon = _canonical_key(self._cache_key(self.posterior))
        icr = self.posterior.icr
        return {
            "digest": hashlib.sha256(canon.encode()).hexdigest()[:16],
            "key": canon,
            "slab": self.slab,
            "device": torch.device(icr.device).type,
            "storage_dtype": str(icr.policy.storage_dtype).removeprefix(
                "torch."),
        }


# -- demo / smoke entry point ----------------------------------------------------
def demo_posterior(chart, rho: float, dtype_policy=None, seed: int = 0, *,
                   device="cuda") -> Posterior:
    """A synthetic mean-field posterior (prior-sample mean, constant
    log-std -1.5) for benchmarks and smoke runs; no fit required."""
    from repro_torch.core import ICR, matern32

    icr = ICR(chart, matern32.with_defaults(rho=rho), use_pallas=True,
              dtype_policy=dtype_policy, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = icr.init_xi(gen, dtype=torch.float32)
    log_std = [torch.full_like(m, -1.5) for m in mean]
    return Posterior(icr=icr, mean=mean, log_std=log_std)


def scenario_chart(name: str, quick: bool = False):
    """The three serving scenarios: 1-D time-ordered data, 2-D image,
    3-D dust map (the paper's flagship chart, reduced)."""
    from repro_torch.core import galactic_dust_chart, regular_chart

    if name == "tod":
        return regular_chart(64, 3 if quick else 5, boundary="reflect")
    if name == "image":
        return regular_chart((16, 16) if quick else (32, 32), 2,
                             boundary="reflect")
    if name == "dust":
        return galactic_dust_chart((6, 8, 8), n_levels=2)
    raise ValueError(f"unknown scenario {name!r}")


SCENARIOS = {"tod": 8.0, "image": 4.0, "dust": 0.5}  # name -> kernel rho


def mixed_requests(n_fields: int = 3, mc: int = 8) -> List[GPRequest]:
    """A heterogeneous batch: sample + moments requests of varying size."""
    return [
        GPRequest(kind="sample", n=n_fields, seed=1),
        GPRequest(kind="moments", n=mc, seed=2),
        GPRequest(kind="sample", n=1, seed=3),
        GPRequest(kind="moments", n=mc // 2, seed=4),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="dust", choices=[*SCENARIOS, "all"])
    ap.add_argument("--slab", type=int, default=8)
    ap.add_argument("--fields", type=int, default=3)
    ap.add_argument("--mc", type=int, default=16)
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    names = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    for name in names:
        chart = scenario_chart(name, quick=args.quick)
        pol = None if args.dtype == "fp32" else "bf16"
        post = demo_posterior(chart, SCENARIOS[name], dtype_policy=pol)
        srv = GPFieldServer(post, slab=args.slab)
        shape = chart.final_shape
        print(f"[{name}] chart {shape} = {int(np.prod(shape)):,} px, "
              f"slab={args.slab}, dtype={args.dtype}, mode={srv.serving_mode}")

        t0 = time.perf_counter()
        srv.run(mixed_requests(args.fields, args.mc))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        reqs = srv.run(mixed_requests(args.fields, args.mc))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0

        failed = [str(r.error) for r in reqs if not r.done or r.error]
        if failed:
            raise RuntimeError(f"[{name}] requests failed: {failed}")
        mom = next(r for r in reqs if r.kind == "moments")
        print(f"  cold {cold*1e3:.0f} ms, warm {warm*1e3:.0f} ms "
              f"({cold/max(warm, 1e-9):.1f}x), "
              f"{srv.rows_served} rows in {srv.slabs_run} slabs, "
              f"{srv.rows_served / (cold + warm):.1f} samples/s")
        print(f"  exec cache: {srv.cache_hits} hits / {srv.cache_misses} "
              f"misses, {srv.graph_captures} graph captures; est "
              f"{srv.modeled_slab_bytes():,} device bytes/slab "
              f"(route={srv.route})")
        print(f"  moments({mom.n}): mean std over field = "
              f"{float(np.mean(mom.std)):.3f}")


if __name__ == "__main__":
    main()
