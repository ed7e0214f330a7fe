"""The LM port's prefill and serve steps on a mesh, held to one slot and
to the JAX package on the CPU.

* ``make_prefill_step`` / ``make_serve_step`` on virtual meshes of CPU
  slots against the port's one-slot step, float32, for the ten reduced
  architectures: (2, 2) (the kv heads over the model slots: each slot
  projects its heads), (1, 4) (the sequence of the cache over the model
  slots: an online softmax over them), and a batch of one on (4, 1)
  (the data axes on the sequence). The one-slot step first writes
  positions 0..WARM-1 of the cache; the mesh takes that cache and both
  decode 4 steps at positions WARM + t + row, which cross from the
  second block of the sequence into the third where the sequence is
  split (blocks of 4): live partials of several blocks merge, rows of
  one block write while others keep, and a later block's keys are
  visible. Logits within 1e-5 of their largest entry at every step, and
  the cache blocks gathered after them equal to the one-slot cache
  within 1e-5.
* The JAX package's own ``make_prefill_step`` / ``make_serve_step`` on
  ``make_host_mesh()`` (one CPU device) against the port's steps on a
  (2, 2) mesh, within 1e-5, for gemma3-4b, deepseek-v2 (MLA, MoE),
  zamba2 (Mamba2: the state's channels over the model slots, stepped in
  place) and xlstm (mLSTM: C split on q·k's dim, in place; n and m,
  which ``cache_specs`` lays out otherwise, gathered and written back).
* The layout each mesh reaches (``Executor.cache_partials``'s branches).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import shard_ctx as jshard_ctx
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed import elastic
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.tree import tree_leaves, tree_map

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 1e-5
B, S, STEPS, S_MAX = 4, 16, 4, 16
WARM = 5            # positions the one-slot step writes before the mesh's
# name -> (mesh shape, batch, (data dim, model dim) of gemma3-4b's k cache:
# the tail layer's on "heads", a global layer's (after the group index)
# on the others; None where the axes do not split it). The local layers'
# ring buffers of (1, 4) split the head dim: gathered whole.
LAYOUTS = {"heads": ((2, 2), B, (0, 2)), "seq": ((1, 4), B, (None, 1)),
           "b1_seq": ((4, 1), 1, (1, 2))}


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def rel(got, want) -> float:
    if isinstance(got, elastic.Placed):     # a mesh step's rows per line
        got = elastic.gather(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def inputs(cfg, b=B, seed=1) -> dict:
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, S),
                                     generator=gen, dtype=torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.d_model), generator=gen)
    return batch


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_sharded_prefill_and_serve_equal_one_slot(name, layout):
    shape, b, _ = LAYOUTS[layout]
    cfg = get_arch(name).reduced()
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          device="cpu")
    batch = inputs(cfg, b)
    _, _, one_for = make_prefill_step(cfg, mesh_of((1, 1)))
    ref = one_for(batch)[0](params, batch)
    _, p_sh, fn_for = make_prefill_step(cfg, mesh_of(shape))
    placed = p_sh.place(params)
    assert rel(fn_for(batch)[0](placed, batch), ref) <= TOL

    model, one, _, _, _ = make_serve_step(cfg, mesh_of((1, 1)), b, S_MAX)
    cache1 = model.init_cache(b, S_MAX, device="cpu")
    if cfg.encoder is not None:
        model.prepare_cross_cache(params, cache1, batch["enc_embeds"])
    for t in range(WARM):
        one(params, cache1, batch["tokens"][:, t:t + 1],
            torch.full((b,), t, dtype=torch.int32))
    _, step, _, c_sh, c_spec = make_serve_step(cfg, mesh_of(shape), b,
                                               S_MAX)
    assert [tuple(t.shape) for t in tree_leaves(c_spec)] == \
        [tuple(t.shape) for t in tree_leaves(cache1)]
    cache = c_sh.place(tree_map(torch.clone, cache1))
    for t in range(STEPS):
        tok = batch["tokens"][:, WARM + t:WARM + t + 1]
        pos = (WARM + t + torch.arange(b)).to(torch.int32)
        want = one(params, cache1, tok, pos)
        assert rel(step(placed, cache, tok, pos), want) <= TOL, (name, t)
    for got, want in zip(elastic.placed_leaves(cache), tree_leaves(cache1)):
        assert rel(elastic.gather(got), want) <= TOL, name


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_reached(layout):
    """The cache of a global attention layer (gemma3-4b's) lands where
    the layout names, and the step's partials combine over the axes that
    split it (an all-reduce of the softmax statistics)."""
    shape, b, dims = LAYOUTS[layout]
    cfg = get_arch("gemma3-4b").reduced()
    model, step, p_sh, c_sh, c_spec = make_serve_step(cfg, mesh_of(shape),
                                                      b, S_MAX)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    cache = c_sh.place(model.init_cache(b, S_MAX, device="cpu"))
    view = step.executor.view(cache)
    leaf = (view["tail"][0]["k"] if layout == "heads"
            else view["groups"]["slot2"]["k"][0])   # a global layer
    assert (leaf.ddim, leaf.mdim) == dims
    step(p_sh.place(params), cache, torch.zeros((b, 1), dtype=torch.int32),
         torch.zeros((b,), dtype=torch.int32))
    reduced = step.executor.counts["all_reduce"]["calls"]
    assert reduced > 0


def _jax_steps(name, params_np, batch_np, toks, positions):
    """The JAX package's prefill logits and serve-step logits on
    ``make_host_mesh()`` from the same parameters."""
    jcfg = JARCHS[name].reduced()
    mesh = jmesh.make_host_mesh()
    try:
        jp = jax.tree.map(jnp.asarray, params_np)
        model, _, jit_for = jsteps.make_prefill_step(jcfg, mesh)
        fn, _ = jit_for({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                         for k, v in batch_np.items()})
        prefill = np.asarray(fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch_np.items()}))
        model, step, _, _, _ = jsteps.make_serve_step(jcfg, mesh, B, S_MAX,
                                                      donate=False)
        cache = model.init_cache(B, S_MAX)
        out = []
        for tok, pos in zip(toks, positions):
            logits, cache = step(jp, cache, jnp.asarray(tok),
                                 jnp.asarray(pos))
            out.append(np.asarray(logits))
        return prefill, out
    finally:
        jshard_ctx.clear()


@pytest.mark.parametrize("name", ["gemma3-4b", "deepseek-v2-236b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_mesh_steps_equal_the_jax_packages(name):
    cfg = get_arch(name).reduced()
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          device="cpu")
    params_np = tree_map(lambda t: t.numpy(), params)
    batch = inputs(cfg)
    toks = [batch["tokens"][:, t:t + 1] for t in range(STEPS)]
    positions = [torch.full((B,), t, dtype=torch.int32)
                 for t in range(STEPS)]
    want_prefill, want = _jax_steps(
        name, params_np, {k: v.numpy() for k, v in batch.items()},
        [t.numpy() for t in toks], [p.numpy() for p in positions])
    mesh = mesh_of((2, 2))
    _, p_sh, fn_for = make_prefill_step(cfg, mesh)
    placed = p_sh.place(params)
    assert rel(fn_for(batch)[0](placed, batch), want_prefill) <= TOL
    model, step, _, c_sh, _ = make_serve_step(cfg, mesh, B, S_MAX)
    cache = c_sh.place(model.init_cache(B, S_MAX, device="cpu"))
    for t, (tok, pos) in enumerate(zip(toks, positions)):
        assert rel(step(placed, cache, tok, pos), want[t]) <= TOL, (name, t)
