"""The port's LM configs and forward pass held to the JAX package on the CPU.

* Every ``ArchConfig`` and its ``reduced()`` equal the JAX package's field
  by field, ``layer_plan`` is equal, and ``param_count`` at FULL size is
  equal (the port counts on the ``meta`` device, the JAX package through
  ``eval_shape``: no full-width layout is allocated).
* The port's reduced parameter tree has the JAX package's structure,
  shapes and dtypes leaf for leaf (against ``eval_shape``).
* For all ten reduced architectures, ``prefill_fn`` logits and
  ``loss_fn``'s (loss, nll, aux) agree within 1e-4 of the largest
  magnitude at float32, on the same parameters.

The modules one by one are in ``test_torch_lm_modules.py``.

The shared parameters are drawn by the port (``init_params`` from a
seeded ``torch.Generator``; the JAX package's eager init of ten
architectures costs ~40 s of XLA compiles on one core), their 1-D
leaves (norm scales, biases, SSM gates) shifted by seeded numpy noise so
that no zero-initialized leaf hides a term; they reach JAX as numpy
arrays and the port through ``lm_params_to_torch``. Inputs are numpy
draws from a seed. The JAX references are jitted, once per architecture
in a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models.transformer import layer_plan as jlayer_plan
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_plan
from repro_torch.models.tree import tree_map

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

NAMES = sorted(ARCHS)
TOL = 1e-4          # relative to the largest magnitude, float32
B, S = 2, 32


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def shared_params(cfg, seed=0):
    """The port's draw, with every 1-D leaf shifted by 0.1 N(0, 1), as
    numpy arrays."""
    gen = torch.Generator().manual_seed(seed)
    params = t2n(build_model(cfg).init_params(gen))
    rng = np.random.default_rng(seed)

    def shift(a):
        if a.ndim == 1:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return tree_map(shift, params)


def batch_np(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -1] = -1                       # a masked label
    batch = {"tokens": tok, "labels": lab}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def plan_tuple(plan):
    """(head, period, n_groups, tail) with each Slot as a tuple."""
    head, period, n_groups, tail = plan
    return ([dataclasses.astuple(s) for s in head],
            [dataclasses.astuple(s) for s in period], n_groups,
            [dataclasses.astuple(s) for s in tail])


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_full_param_count(name):
    cfg, jcfg = get_arch(name), JARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.dtype() == torch.bfloat16 and \
        cfg.reduced().dtype() == torch.float32
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert plan_tuple(layer_plan(c)) == plan_tuple(jlayer_plan(jc))
    assert build_model(cfg).param_count() == \
        jbuild_model(jcfg).param_count()


@pytest.fixture(scope="module", params=NAMES)
def arch(request):
    """(name, numpy params, numpy batch, JAX prefill logits, JAX loss
    triple) for one reduced architecture."""
    name = request.param
    jcfg = JARCHS[name].reduced()
    jmodel = jbuild_model(jcfg)
    params = shared_params(get_arch(name).reduced())
    batch = batch_np(jcfg)

    @jax.jit
    def ref(p, b):
        loss, metrics = jmodel.loss_fn(p, b)
        return jmodel.prefill_fn(p, b), loss, metrics["nll"], metrics["aux"]

    jp = jax.tree.map(jnp.asarray, params)
    out = ref(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    spec = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    return name, params, batch, [np.asarray(o) for o in out], spec


def test_param_tree_matches_the_jax_layout(arch):
    name, params, _, _, spec = arch
    got = jax.tree_util.tree_structure(params)
    want = jax.tree_util.tree_structure(spec)
    assert got == want, name
    for a, s in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(spec)):
        assert a.shape == s.shape and a.dtype == s.dtype, name


def test_prefill_and_loss_match_jax(arch):
    name, params, batch, (logits, loss, nll, aux), _ = arch
    model = build_model(get_arch(name).reduced())
    p = lm_params_to_torch(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.prefill_fn(p, tb)
    assert got.dtype == torch.float32 and got.shape == logits.shape
    assert rel(got.numpy(), logits) <= TOL, name
    tloss, metrics = model.loss_fn(p, tb)
    for g, w in ((tloss, loss), (metrics["nll"], nll),
                 (metrics["aux"], aux)):
        assert abs(float(g) - float(w)) <= TOL * max(abs(float(loss)), 1.0)
