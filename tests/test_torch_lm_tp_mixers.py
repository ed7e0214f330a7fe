"""The tensor-parallel forms of MLA, Mamba2, mLSTM, sLSTM, the MoE router
and the stub frontends on a mesh, held on the CPU.

* Reduced deepseek-v2 (MLA, the router), internvl2 (the vision
  frontend), whisper (``pos_embed``, the decoder's cross attention),
  xlstm (mLSTM) and zamba2 (Mamba2) on virtual (2, 2) and (1, 4) meshes
  of CPU slots: the loss and every gradient leaf against the JAX
  package's ``jax.value_and_grad(loss_fn)`` on the same numpy
  parameters and batch, within 1e-5 (the JAX gradients computed once per
  architecture, for both meshes). A key bias whose gradient is zero in
  exact arithmetic is held to 1e-6 of the largest entry on both sides
  (``test_torch_lm_grad.check_grads``).
* A recorder names every leaf that reaches ``Executor.full``,
  ``Executor.take`` (``narrow``, ``part``) and ``Executor.columns``: on
  both meshes, in the train step and in a prefill and decode step, no
  leaf of these mixers reaches ``full``, and each is read per slot.
* Reduced xlstm on (1, 8): its 4 heads do not divide 8, so the mLSTM
  splits q·k's dim (C's dim 2, where ``cache_specs`` puts the model
  axis); its gradients equal one slot's within 1e-5, and so does a
  decode step that reads and writes C in place.
* sLSTM (no reduced architecture has one: xlstm's every 8th layer, cut
  to 4 layers) on a reduced xlstm with every 2nd layer an sLSTM, on
  (2, 2) and (1, 8): gradients and decode against one slot, its
  projections read per slot and only its recurrence's ``r_gates`` whole.
* ``Executor.narrow`` / ``take`` over runs that span model blocks equal
  ``x.narrow`` of the whole leaf, with an equal gradient, and count the
  bytes read from the other slots' blocks only.
* On ``meta`` (1, 4) slots, the FLOPs of one Mamba2 layer and of one MLA
  layer per model slot: the one-slot FLOPs less the parts every slot
  computes whole, over 4, plus those parts. Kept whole on every slot:
  Mamba2's B and C projections (``w_in``'s 2·d_state columns) and the
  SSD's C·Bᵀ scores; for MLA nothing (its latents are column-parallel
  and gathered: whole in memory, not in FLOPs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_to_torch
from repro_torch.distributed import elastic
from repro_torch.distributed.executor import Executor, ShardLeaf, TPLeaf
from repro_torch.distributed.sharding import param_specs, shardings_for
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention, build_model, shard_ctx, ssm
from repro_torch.models.shard_ctx import owning
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.roofline.op_cost import OpCounter
from test_torch_lm_grad import leaf_names
from test_torch_lm_models import batch_np, rel, shared_params

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 1e-5
NAMES = ["deepseek-v2-236b", "internvl2-2b", "whisper-base", "xlstm-1.3b",
         "zamba2-7b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the leaves each architecture's new forms read per slot
MIXER_LEAVES = {
    "deepseek-v2-236b": {"w_dq", "w_dkv", "w_uq", "w_uk", "w_uv", "wo",
                         "router"},
    "internvl2-2b": {"frontend"},
    "whisper-base": {"pos_embed"},
    "xlstm-1.3b": {"wqkv", "wif", "wo_gate", "wo"},
    "zamba2-7b": {"w_in", "w_out"},
}


def mesh_of(shape, device="cpu"):
    return make_mesh(shape, ("data", "model"),
                     devices=[device] * int(np.prod(shape)))


def is_mixer(name: str, path: tuple) -> bool:
    """Is the leaf at `path` one of the mixers this slice splits?"""
    return (any(k in path for k in ("mamba", "mlstm", "slstm", "router",
                                    "frontend", "pos_embed", "cross_attn"))
            or (name.startswith("deepseek") and "attn" in path))


class Recorder:
    """Names (key paths) of the leaves that reach ``Executor.full``, and
    of those read per slot (``take``, ``columns``)."""

    def __init__(self, monkeypatch):
        self.names: dict = {}
        self.keep: list = []          # no id is reused while recording
        self.full: set = set()
        self.read: set = set()
        rec = self
        view, getitem = Executor.view, ShardLeaf.__getitem__
        gather, full = Executor.gather, Executor.full
        take, columns = Executor.take, Executor.columns

        def name(obj, path):
            rec.keep.append(obj)
            rec.names[id(obj)] = path

        def walk(t, path):
            if isinstance(t, ShardLeaf):
                name(t, path)
            elif isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (str(k),))
            elif isinstance(t, (list, tuple)):
                for i, v in enumerate(t):
                    walk(v, path + (str(i),))

        def rec_view(self, tree, subst=None):
            out = view(self, tree, subst)
            walk(out, ())
            return out

        def rec_getitem(self, i):
            out = getitem(self, i)
            name(out, rec.names.get(id(self)))
            return out

        def rec_gather(self, leaf):
            out = gather(self, leaf)
            name(out, rec.names.get(id(leaf)))
            return out

        def rec_full(self, x):
            if isinstance(x, TPLeaf):
                rec.full.add(rec.names.get(id(x)))
            return full(self, x)

        def rec_take(self, x, *a):
            rec.read.add(rec.names.get(id(x)))
            return take(self, x, *a)

        def rec_columns(self, fn, x, w):
            rec.read.add(rec.names.get(id(w)))
            return columns(self, fn, x, w)

        for cls, attr, fn in ((Executor, "view", rec_view),
                              (ShardLeaf, "__getitem__", rec_getitem),
                              (Executor, "gather", rec_gather),
                              (Executor, "full", rec_full),
                              (Executor, "take", rec_take),
                              (Executor, "columns", rec_columns)):
            monkeypatch.setattr(cls, attr, fn)

    def check(self, name: str) -> None:
        bad = sorted(p for p in self.full if p and is_mixer(name, p))
        assert not bad, (name, bad)
        read = {p[-1] for p in self.read if p and is_mixer(name, p)}
        assert MIXER_LEAVES[name] <= read, (name, read)


@pytest.fixture(scope="module", params=NAMES)
def jax_grads(request):
    """(name, numpy params, numpy batch, JAX loss, JAX gradient leaves)."""
    name = request.param
    jm = jbuild_model(JARCHS[name].reduced())
    params = shared_params(get_arch(name).reduced())
    batch = batch_np(jm.cfg)
    vg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    (loss, _), grads = vg(jax.tree.map(jnp.asarray, params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return (name, params, batch, float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_grads_equal_the_jax_packages(jax_grads, mesh_name,
                                              monkeypatch):
    name, params, batch, jloss, jgrads = jax_grads
    cfg = get_arch(name).reduced()
    ts = steps.make_train_step(cfg, mesh_of(MESHES[mesh_name]))
    placed = ts.params_sh.place(lm_params_to_torch(params, device="cpu"))
    rec = Recorder(monkeypatch)
    loss, _, grads = ts.executor.grads(
        ts.model.loss_fn, placed,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    rec.check(name)
    assert abs(float(loss) - jloss) <= TOL * abs(jloss), name
    got = [elastic.gather(g) for g in elastic.placed_leaves(grads)]
    top = max(np.abs(w).max() for w in jgrads)
    for path, g, w in zip(leaf_names(params), got, jgrads):
        g = g.numpy()
        if path[-1] == "bk" and np.abs(w).max() <= 1e-6 * top:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top
        else:
            assert rel(g, w) <= TOL, (name, path, rel(g, w))


def _serve(cfg, shape, params, b=4, s=8, s_max=16, steps_n=2) -> tuple:
    """A prefill and `steps_n` decode steps on a mesh of `shape` and on
    one slot from the same cache: (prefill logits, decode logits, the
    mesh's cache gathered) of each."""
    gen = torch.Generator().manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (b, s + steps_n), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok[:, :s]}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    def whole(x):
        return elastic.gather(x) if isinstance(x, elastic.Placed) else x

    out = []
    for mesh in (mesh_of((1, 1)), mesh_of(shape)):
        _, p_sh, fn_for = make_prefill_step(cfg, mesh)
        p = params if p_sh is None else p_sh.place(params)
        model, step, _, c_sh, _ = make_serve_step(cfg, mesh, b, s_max)
        cache = model.init_cache(b, s_max, device="cpu")
        if cfg.encoder is not None:
            model.prepare_cross_cache(params, cache, batch["enc_embeds"])
        if c_sh is not None:
            cache = c_sh.place(cache)
        prefill = whole(fn_for(batch)[0](p, batch))
        logits = [whole(step(p, cache, tok[:, s + t:s + t + 1],
                             torch.full((b,), t, dtype=torch.int32)))
                  for t in range(steps_n)]
        out.append((prefill, logits, [whole(x) for x in
                                      elastic.placed_leaves(cache)]
                    if c_sh is not None else tree_leaves(cache)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_read_the_mixers_per_slot(name, mesh_name,
                                                     monkeypatch):
    """The prefill and two decode steps on the mesh: no mixer leaf reaches
    ``full`` (whisper's cross attention in decode included), and the
    logits and cache equal one slot's."""
    cfg = get_arch(name).reduced()
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          device="cpu")
    rec = Recorder(monkeypatch)
    (p1, l1, c1), (pm, lm, cm) = _serve(cfg, MESHES[mesh_name], params)
    rec.check(name)
    if name == "whisper-base":
        assert {p[-1] for p in rec.read if p and "cross_attn" in p} >= \
            {"wo"}
    assert rel(pm, p1) <= TOL
    for a, b in zip(lm, l1):
        assert rel(a, b) <= TOL, name
    for a, b in zip(cm, c1):
        assert rel(a, b) <= TOL, name


def _forms(monkeypatch) -> list:
    """The (heads, q·k dim) tiles ``ssm._mlstm_local`` is asked for."""
    seen = []
    inner = ssm._mlstm_local

    def rec(ex, params, hs, ds, *a):
        seen.append(((hs.start, hs.stop), (ds.start, ds.stop)))
        return inner(ex, params, hs, ds, *a)

    monkeypatch.setattr(ssm, "_mlstm_local", rec)
    return seen


def _one_slot_grads(cfg, params, batch):
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _ = build_model(cfg).loss_fn(p, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(p),
                                              allow_unused=True,
                                              materialize_grads=True)


def _xlstm(slstm_every=None):
    cfg = get_arch("xlstm-1.3b").reduced()
    if slstm_every:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, slstm_every=slstm_every))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    return cfg, params, batch


@pytest.mark.parametrize("case", ["mlstm-1x8", "slstm-2x2", "slstm-1x8"])
def test_xlstm_forms_equal_one_slot(case, monkeypatch):
    """mLSTM on (1, 8) splits q·k's dim (4 heads do not divide 8); sLSTM
    (every 2nd layer) on (2, 2) and (1, 8). Gradients and a decode step
    against one slot."""
    kind, shape = case.split("-")
    shape = tuple(int(x) for x in shape.split("x"))
    cfg, params, batch = _xlstm(2 if kind == "slstm" else None)
    loss1, g1 = _one_slot_grads(cfg, params, batch)
    ts = steps.make_train_step(cfg, mesh_of(shape))
    seen = _forms(monkeypatch)
    rec = Recorder(monkeypatch)
    loss, _, grads = ts.executor.grads(ts.model.loss_fn,
                                       ts.params_sh.place(params), batch)
    if kind == "slstm":
        # its projections per slot; only its recurrence's r_gates whole
        assert {p[-1] for p in rec.full if p and "slstm" in p} <= \
            {"r_gates"}
        assert {"w_gates", "wo"} <= {p[-1] for p in rec.read
                                     if p and "slstm" in p}
    assert abs(float(loss) - float(loss1)) <= TOL * abs(float(loss1))
    got = [elastic.gather(g) for g in elastic.placed_leaves(grads)]
    for g, w in zip(got, g1):
        assert rel(g, w) <= TOL, case
    if shape == (1, 8):
        # each slot: all 4 heads, 2 of the 16 dims of q·k
        assert seen and {hs for hs, _ in seen} == {(0, 4)}
        assert {ds[1] - ds[0] for _, ds in seen} == {2}
    (p1, l1, c1), (pm, lm, cm) = _serve(cfg, shape, params)
    for a, b in zip([pm] + lm + cm, [p1] + l1 + c1):
        assert rel(a, b) <= TOL, case


@pytest.mark.parametrize("runs", [((2, 5),), ((1, 2), (7, 4))])
def test_take_assembles_runs_from_the_blocks_holding_them(runs):
    """A (8, 12) leaf in 4 column blocks of 3: the runs, read by slot 0
    (the line's), equal the whole leaf's columns, their gradient too; the
    bytes counted are those of the columns outside block 0, once forward
    (all-gather) and once back (reduce-scatter)."""
    ex = Executor(mesh_of((1, 4)))
    x = torch.randn((8, 12), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    leaf = TPLeaf(list(x.split(3, dim=1)), 1, x.shape)
    w = torch.randn((8, sum(n for _, n in runs)))
    got = ex.take(leaf, 1, runs, "cpu")
    want = torch.cat([x.narrow(1, s, n) for s, n in runs], dim=1)
    assert torch.equal(got, want)
    (g_got,) = torch.autograd.grad((got * w).sum(), x)
    (g_want,) = torch.autograd.grad((want * w).sum(), x)
    assert torch.equal(g_got, g_want)
    outside = sum(1 for s, n in runs for c in range(s, s + n) if c >= 3)
    assert ex.counts["all_gather"]["bytes"] == outside * 8 * 4
    assert ex.counts["reduce_scatter"]["bytes"] == outside * 8 * 4
    if len(runs) == 1:
        ex.reset()
        assert torch.equal(ex.narrow(leaf, 1, *runs[0], "cpu"), want)
        assert ex.counts["all_gather"]["bytes"] == outside * 8 * 4


def _mixer_flops(name, fn) -> tuple:
    """(FLOPs of `fn(params, x)` on one slot, per model slot on (1, 4)),
    on ``meta``: one layer's parameters of reduced `name`, x (2, 32, D)."""
    cfg = get_arch(name).reduced()
    spec = build_model(cfg).params_spec()["groups"]["slot0"]
    spec = tree_map(lambda t: t[0], spec)
    x = torch.empty((2, 32, cfg.d_model), device="meta")
    with OpCounter() as one:
        fn(cfg, spec, x)
    mesh = mesh_of((1, 4), "meta")
    placed = shardings_for(param_specs(spec, mesh), mesh).place(spec)
    ex = shard_ctx.bind(Executor(mesh))
    try:
        with owning(("home", 1)):
            p = ex.gather_tree(ex.view(placed))
        with OpCounter() as c, owning(("home", 1)):
            fn(cfg, p, x)
    finally:
        shard_ctx.clear()
    return one.flops, [c.by_owner[(0, m)]["flops"] for m in range(4)], cfg


def test_per_slot_mixer_flops_fall_to_a_quarter():
    def mamba(cfg, p, x):
        return ssm.mamba2_train(p["mamba"], x, cfg.ssm, cfg.d_model)

    def mla(cfg, p, x):
        pos = torch.zeros(x.shape[:2], dtype=torch.int32, device="meta")
        return attention.mla_train(p["attn"], x, pos, n_heads=cfg.n_heads,
                                   mla=cfg.mla)

    one, slots, cfg = _mixer_flops("zamba2-7b", mamba)
    b, s, d, n = 2, 32, cfg.d_model, cfg.ssm.d_state
    c = min(cfg.ssm.chunk, s)
    whole = 2 * b * s * d * 2 * n + 2 * b * (s // c) * c * c * n
    for f in slots:
        assert f == pytest.approx((one - whole) / 4 + whole, rel=0.05)
    assert max(slots) < 0.35 * one
    one, slots, _ = _mixer_flops("deepseek-v2-236b", mla)
    for f in slots:
        assert f == pytest.approx(one / 4, rel=0.05)
