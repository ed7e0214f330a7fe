"""The port's sharded LM executor held to its one-slot step on the CPU.

Virtual meshes of CPU slots (``make_mesh(..., devices=["cpu"] * n)``),
the three of ``chip_smoke.py`` phase 11a: (data 2, model 2) reaches the
"head" layout with the kv heads split, (1, 4) "head" with the kv heads
repeated group-wise (the reduced archs have 4 q heads and 2 kv heads),
(1, 8) "key"; and for the gradients (4, 1) and (4, 2), one row per line.
The one-slot step is itself held to the JAX package
(``tests/test_torch_lm_train.py``, ``test_torch_lm_grad*.py``).

* The loss and every gradient leaf of the ten reduced architectures
  (float32, seeded parameters and batch, the last row's labels partly
  masked, so that the lines' masked counts differ) on each mesh against
  one slot, within 1e-5 of the leaf's largest entry (a leaf zero in
  exact arithmetic is held by its level against the largest entry of
  all).
* The train step at accum 2 on (2, 2) against one slot's, SGD at a fixed
  rate, each parameter leaf within 1e-5.
* SGD (momentum), AdamW and Adafactor on placed leaves: two updates from
  the same gradients against the one-slot updates, within 1e-5.
* The layout each mesh reaches, asserted through ``head_tp_available``
  and the executor's attention path.
* The executor's all-gather and reduce-scatter bytes equal the formula
  from the specs; the executor is unbound after a step.
* A checkpoint of a placed tree records the specs and restores onto a
  mesh of another shape; a mesh with too few devices raises.
"""
import json
import unittest.mock

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import elastic
from repro_torch.distributed.sharding import param_specs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import attention, build_model, shard_ctx
from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import constant, optimizers

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = 1e-5
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "1x8": (1, 8)}
# the gradients also on four lines, one row each
GRAD_MESHES = dict(MESHES, **{"4x1": (4, 1), "4x2": (4, 2)})
LAYOUT = {"2x2": ("head", True), "1x4": ("head", False), "1x8": ("key",
                                                                 None)}


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def reduced_batch(cfg) -> dict:
    """A seeded batch of 4 rows of 32 tokens (and the frontends'), the
    last row's labels masked past position 12."""
    host = SyntheticLMData(cfg.vocab_size, 32, 4, seed=3).batch(0)
    host["labels"][3, 12:] = -1
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    gen = torch.Generator().manual_seed(4)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (4, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.randn(
            (4, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    return batch


def leaf_errs(got, want) -> tuple:
    """(max over leaves of max|got - want| / max|want|, the level of the
    leaves whose reference is below 1e-6 of the largest entry of all)."""
    top = max(float(w.detach().abs().max()) for w in want)
    worst, zero = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.detach().double(), w.detach().double()
        scale = float(w.abs().max())
        if scale <= 1e-6 * top:
            zero = max(zero, float(g.abs().max()) / top, scale / top)
        else:
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst, zero


def whole(tree) -> list:
    return [elastic.gather(x) for x in elastic.placed_leaves(tree)]


_ONE: dict = {}


def one_slot(name):
    """(cfg, params, batch, loss, gradient leaves) on one slot."""
    if name not in _ONE:
        cfg = get_arch(name).reduced()
        model = build_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0))
        batch = reduced_batch(cfg)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        params = tree_map(lambda t: t.detach(), params)
        _ONE[name] = (cfg, params, batch, loss.detach(),
                      [g.detach() for g in grads])
    return _ONE[name]


def sharded(cfg, mesh, params, **kw):
    ts = steps.make_train_step(cfg, mesh, **kw)
    return ts, ts.params_sh.place(tree_map(torch.clone, params))


@pytest.mark.parametrize("mesh_name", sorted(GRAD_MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_sharded_grads_match_one_slot(name, mesh_name):
    cfg, params, batch, loss1, grads1 = one_slot(name)
    ts, placed = sharded(cfg, mesh_of(GRAD_MESHES[mesh_name]), params)
    loss, _, grads = ts.executor.grads(ts.model.loss_fn, placed, batch)
    assert abs(float(loss) - float(loss1)) <= TOL * abs(float(loss1))
    worst, zero = leaf_errs(whole(grads), grads1)
    assert worst <= TOL and zero <= 1e-6, (worst, zero)
    assert shard_ctx.executor() is None and shard_ctx.model_size() == 1


def fixed_sgd(lr=0.5):
    sgd = (optimizers.sgd(constant(lr)), "sgd")
    return unittest.mock.patch.object(steps, "select_optimizer",
                                      lambda model, total_steps=0: sgd)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_sharded_step_accum2_matches_one_slot(name):
    cfg, params, batch, _, _ = one_slot(name)
    outs = []
    for mesh in (make_host_mesh(devices=["cpu"]), mesh_of((2, 2))):
        with fixed_sgd():
            ts = steps.make_train_step(cfg, mesh, accum=2)
        p = tree_map(torch.clone, params)
        state = ts.optimizer.init(p)
        if ts.params_sh is not None:
            p, state = ts.params_sh.place(p), ts.opt_sh.place(state)
        new, _, metrics = ts.fn(p, state, batch)
        outs.append((float(metrics["loss"]),
                     whole(new) if ts.params_sh is not None
                     else tree_leaves(new)))
    assert abs(outs[1][0] - outs[0][0]) <= TOL * abs(outs[0][0])
    worst, zero = leaf_errs(outs[1][1], outs[0][1])
    assert worst <= TOL and zero <= 1e-6, (worst, zero)


OPTS = {"sgd": lambda: optimizers.sgd(constant(1e-2), 0.9),
        "adamw": lambda: optimizers.adamw(constant(1e-3), weight_decay=0.1),
        "adafactor": lambda: optimizers.adafactor(constant(1e-3)),
        # the reduced leaves' trailing dims are 64 to 512: factor them
        "adafactor_factored": lambda: optimizers.adafactor(
            constant(1e-3), min_dim_size_to_factor=32)}


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "starcoder2-15b"])
def test_optimizers_on_blocks_match_one_slot(name, mesh_name, opt):
    """Two updates from the same gradients: each distinct block updated
    once, the global norm and Adafactor's statistics over all blocks (its
    full second moment at the default size rule, which factors none of
    the reduced leaves; its row and column statistics with the rule
    lowered to 32)."""
    cfg, params, _, _, grads1 = one_slot(name)
    mesh = mesh_of(MESHES[mesh_name])
    with unittest.mock.patch.object(
            steps, "select_optimizer",
            lambda model, total_steps=0: (OPTS[opt](), opt)):
        ts = steps.make_train_step(cfg, mesh)
    g = tree_unflatten(params, [x.clone() for x in grads1])
    outs = []
    for placed in (False, True):
        o = OPTS[opt]()
        p = tree_map(torch.clone, params)
        state = o.init(p)
        gg = g
        if placed:
            p, state = ts.params_sh.place(p), ts.opt_sh.place(state)
            gg = ts.params_sh.place(g)
        for _ in range(2):
            p, state = o.update(gg, state, p)
        if placed:
            outs.append(whole(p) + whole(state.inner))
        else:
            outs.append(tree_leaves(p) + tree_leaves(state.inner))
    worst, zero = leaf_errs(outs[1], outs[0])
    assert worst <= TOL and zero <= 1e-6, (worst, zero)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_layout_each_mesh_reaches(mesh_name):
    cfg, params, batch, _, _ = one_slot("gemma3-4b")
    mesh = mesh_of(MESHES[mesh_name])
    mode, split_kv = LAYOUT[mesh_name]
    shard_ctx.set_axes(mesh, ("data",), ("model",))
    try:
        assert shard_ctx.model_size() == MESHES[mesh_name][1]
        assert attention.head_tp_available(cfg.n_heads, cfg.n_kv_heads) \
            == (mode == "head")
    finally:
        shard_ctx.clear()
    seen = []
    heads, keys = attention._attention_heads, attention._sdpa_keys

    def rec_heads(ex, *a, n_heads, n_kv, **kw):
        seen.append(("head", n_kv % ex.M == 0 and n_kv >= ex.M))
        return heads(ex, *a, n_heads=n_heads, n_kv=n_kv, **kw)

    def rec_keys(*a):
        seen.append(("key", None))
        return keys(*a)

    ts, placed = sharded(cfg, mesh, params)
    with unittest.mock.patch.object(attention, "_attention_heads",
                                    rec_heads), \
            unittest.mock.patch.object(attention, "_sdpa_keys", rec_keys):
        ts.executor.grads(ts.model.loss_fn, placed, batch)
    assert seen and set(seen) == {(mode, split_kv)}


def test_collective_bytes_equal_the_spec_formula():
    """starcoder2 on (2, 2): every leaf split over the data axes is
    gathered once per step (no remat) and its gradient reduce-scattered
    once; bytes are summed over the 4 slots."""
    cfg, params, batch, _, _ = one_slot("starcoder2-15b")
    mesh = mesh_of((2, 2))
    ts, placed = sharded(cfg, mesh, params)
    ts.fn(placed, ts.opt_sh.place(ts.optimizer.init(params)), batch)
    specs = param_specs(params, mesh)
    ag = rs = calls = 0
    for spec, leaf in zip(_walk_specs(specs), tree_leaves(params)):
        if "data" not in spec:
            continue
        m = 2 if "model" in spec else 1
        rows = leaf.shape[0] if leaf.ndim == 3 else 1   # stacked groups
        ag += 4 * leaf.numel() // m * leaf.element_size()
        rs += 4 * leaf.numel() // (2 * m) * leaf.element_size()
        calls += rows
    counts = ts.executor.counts
    assert counts["all_gather"]["bytes"] == ag > 0
    assert counts["reduce_scatter"]["bytes"] == rs
    assert counts["all_gather"]["calls"] == counts["reduce_scatter"][
        "calls"] == calls
    assert counts["all_reduce"]["calls"] > 0


def _walk_specs(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk_specs(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _walk_specs(v)]
    return [tree]


def test_checkpoint_specs_restore_on_another_mesh(tmp_path):
    cfg, params, _, _, _ = one_slot("internvl2-2b")
    ts, placed = sharded(cfg, mesh_of((2, 2)), params)
    state = ts.opt_sh.place(ts.optimizer.init(params))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, (placed, state), blocking=True,
              spec_tree=(ts.params_sh.spec_tree, ts.opt_sh.spec_tree))
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = {e["name"]: e["spec"] for e in json.load(f)["leaves"]}
    assert manifest["0__embed__table"] == ["model", None]
    assert manifest["0__lm_head"] == ["data", "model"]
    assert manifest["1__0"] == []             # the step count: P()
    for shape in ((1, 4), (2, 2)):
        mesh = mesh_of(shape)
        step, (p2, s2) = ckpt.restore((placed, state), mesh=mesh)
        assert step == 3
        assert all(pl.mesh is mesh for pl in elastic.placed_leaves(p2))
        for a, b in zip(whole(p2) + whole(s2), whole(placed) + whole(state)):
            assert torch.equal(a, b)
    lm = elastic.placed_leaves({"lm_head": p2["lm_head"]})[0]
    assert len({id(t) for t in lm}) == 4 and lm[0].shape == (32, 256)


def test_a_mesh_needs_its_devices():
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        from repro_torch.launch.train import train_loop

        mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda"] * 4)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train_loop(get_arch("starcoder2-15b").reduced(), mesh, steps=1,
                       global_batch=2, seq_len=16)


def test_executor_needs_a_data_model_mesh():
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="data..., model"):
        steps.make_train_step(get_arch("starcoder2-15b").reduced(), mesh)
