"""The port's sharding rules held to the JAX package's, leaf by leaf.

``param_specs``, ``opt_state_specs`` (AdamW and Adafactor state),
``batch_spec`` and ``cache_specs`` of ``repro_torch.distributed.sharding``
against ``repro.distributed.sharding`` on the production mesh shapes
(16x16 and 2x16x16, faked: the rules read only ``mesh.shape``) for the
ten full-size architectures: the JAX package's trees from ``eval_shape``
(``params_spec``, ``cache_spec``), the port's on the ``meta`` device,
nothing allocated. Specs are normalised as ``tests/test_sharding.py``
does (a one-axis tuple is that axis).
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.distributed import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import P
from repro_torch.models import build_model
from repro_torch.optim import constant, optimizers

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)


class FakeMesh:
    """Spec rules only consult mesh.shape."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": (FakeMesh(data=16, model=16), ("data",)),
          "2x16x16": (FakeMesh(pod=2, data=16, model=16), ("pod", "data"))}


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _norm_spec(spec) -> tuple:
    return tuple(_norm(e) for e in spec)


def jax_leaves(specs, shapes) -> list:
    """[(spec, shape)] of a JAX spec tree and its shape tree, in pytree
    order."""
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    flat_t = jax.tree_util.tree_leaves(shapes)
    assert len(flat_s) == len(flat_t)
    return [(_norm_spec(s), tuple(t.shape)) for s, t in zip(flat_s, flat_t)]


def _walk(tree, leaf) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk(tree[k], leaf)]
    if isinstance(tree, (list, tuple)) and not leaf(tree):
        return [x for v in tree for x in _walk(v, leaf)]
    return [] if tree is None else [tree]


def port_leaves(specs, shapes) -> list:
    flat_s = _walk(specs, lambda x: isinstance(x, P))
    flat_t = _walk(shapes, lambda x: False)
    assert len(flat_s) == len(flat_t)
    return [(_norm_spec(s), tuple(t.shape)) for s, t in zip(flat_s, flat_t)]


def _axes(mesh_name):
    mesh, data_axes = MESHES[mesh_name]
    return mesh, data_axes, ("model",)


@pytest.fixture(scope="module")
def trees():
    """Both packages' full-size parameter trees, shapes only."""
    return {name: (jbuild_model(JARCHS[name]).params_spec(),
                   build_model(get_arch(name)).params_spec())
            for name in sorted(ARCHS)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_jax(trees, name, mesh_name):
    mesh, data_axes, model_axes = _axes(mesh_name)
    jp, pp = trees[name]
    want = jax_leaves(jsharding.param_specs(jp, mesh, data_axes, model_axes),
                      jp)
    got = port_leaves(sharding.param_specs(pp, mesh, data_axes, model_axes),
                      pp)
    assert got == want


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_opt_state_specs_equal_jax(trees, name, mesh_name, opt):
    mesh, data_axes, model_axes = _axes(mesh_name)
    jp, pp = trees[name]
    jopt = {"adamw": jadamw, "adafactor": jadafactor}[opt](jconstant(1e-3))
    popt = {"adamw": optimizers.adamw,
            "adafactor": optimizers.adafactor}[opt](constant(1e-3))
    js = jax.eval_shape(jopt.init, jp)
    ps = popt.init(pp)
    want = jax_leaves(jsharding.opt_state_specs(js, mesh, data_axes,
                                                model_axes), js)
    got = port_leaves(sharding.opt_state_specs(ps, mesh, data_axes,
                                               model_axes), ps)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 16, 32, 256])
def test_batch_spec_equals_jax(mesh_name, batch):
    mesh, data_axes, _ = _axes(mesh_name)
    jb = {"tokens": jax.ShapeDtypeStruct((batch, 4096), "int32"),
          "labels": jax.ShapeDtypeStruct((batch, 4096), "int32"),
          "patch_embeds": jax.ShapeDtypeStruct((batch, 256, 2048),
                                               "float32")}
    pb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    want = jax_leaves(jsharding.batch_spec(jb, mesh, data_axes), jb)
    got = port_leaves(sharding.batch_spec(pb, mesh, data_axes), pb)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_specs_equal_jax(name, mesh_name, batch):
    """Decode caches at a 32k context; batch 1 puts the data axes on the
    sequence."""
    mesh, data_axes, model_axes = _axes(mesh_name)
    jc = jbuild_model(JARCHS[name]).cache_spec(batch, 32768)
    pc = build_model(get_arch(name)).init_cache(batch, 32768, device="meta")
    want = jax_leaves(jsharding.cache_specs(jc, mesh, data_axes, model_axes),
                      jc)
    got = port_leaves(sharding.cache_specs(pc, mesh, data_axes, model_axes),
                      pc)
    assert got == want
