"""The port's LM backward held to the JAX package on the CPU, attention
and dense architectures (``test_torch_lm_grad_mix.py`` has the MoE, SSM
and hybrid ones).

For each reduced architecture at float32, the port's ``loss_fn`` and
``torch.autograd.grad`` of it against ``jax.value_and_grad(loss_fn,
has_aux=True)`` on the same parameters and batch: the loss within 1e-4 of
its magnitude, every gradient leaf within 1e-4 of that leaf's largest
entry. With ``remat=True`` (the layer groups, and inside them the query
chunks, checkpointed) the port's gradients equal its ``remat=False``
ones bit for bit.

Where no rotary embedding follows it (whisper), a key bias (``bk``)
adds one constant to every score of a query, which the softmax cancels:
its gradient is zero in exact arithmetic, and both sides give rounding
noise (~1e-10). Such a leaf (a ``bk`` whose JAX gradient is below 1e-6
of the model's largest gradient entry) is held to that level on both
sides instead of to its own largest entry.

The parameters are the port's seeded draw with every 1-D leaf shifted by
seeded numpy noise (no zero-initialized leaf hides a term), carried to
JAX as numpy arrays and to the port through ``lm_params_to_torch``
(``test_torch_lm_models``' helpers); the JAX reference is jitted once per
architecture in a module-scoped fixture.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import build_model
from repro_torch.models.tree import tree_leaves, tree_map
from test_torch_lm_models import batch_np, rel, shared_params

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

NAMES = ["command-r-35b", "gemma3-27b", "gemma3-4b", "internvl2-2b",
         "starcoder2-15b", "whisper-base"]
# dense/local-global at 1,024 tokens (two query chunks, banded), enc-dec
REMAT = [("gemma3-4b", 1024), ("whisper-base", 32)]
TOL = 1e-4


def leaf_names(tree, path=()):
    """Each leaf's key path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                           path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, path + (i,))]
    return [path]


def check_grads(name, params, grads, jgrads):
    """Every leaf within TOL of its largest entry; a key bias whose
    gradient is zero in exact arithmetic within 1e-6 of the model's
    largest entry."""
    assert len(grads) == len(jgrads)
    top = max(np.abs(w).max() for w in jgrads)
    for path, g, w in zip(leaf_names(params), grads, jgrads):
        g = g.detach().numpy()
        if path[-1] == "bk" and np.abs(w).max() <= 1e-6 * top:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top
        else:
            assert rel(g, w) <= TOL, (name, path, rel(g, w))


def port_grads(cfg, params, batch):
    """(loss, nll, aux, gradient leaves) of the port on the CPU."""
    p = tree_map(lambda t: t.requires_grad_(True),
                 lm_params_to_torch(params, device="cpu"))
    loss, metrics = build_model(cfg).loss_fn(
        p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_map(torch.detach, metrics), grads


@pytest.fixture(scope="module", params=NAMES)
def arch(request):
    """(name, numpy params, numpy batch, JAX (loss, nll, aux), JAX
    gradient leaves) for one reduced architecture."""
    name = request.param
    jmodel = jbuild_model(JARCHS[name].reduced())
    params = shared_params(get_arch(name).reduced())
    batch = batch_np(jmodel.cfg)
    vg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))
    (loss, metrics), grads = vg(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return (name, params, batch,
            [float(loss), float(metrics["nll"]), float(metrics["aux"])],
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def test_loss_and_grads_match_jax(arch):
    name, params, batch, want, jgrads = arch
    loss, metrics, grads = port_grads(get_arch(name).reduced(), params,
                                      batch)
    for g, w in zip((loss, metrics["nll"], metrics["aux"]), want):
        assert abs(float(g) - w) <= TOL * max(abs(want[0]), 1.0), name
    check_grads(name, params, grads, jgrads)


@pytest.mark.parametrize("name,s", REMAT)
def test_remat_grads_equal_no_remat_bit_for_bit(name, s):
    cfg = get_arch(name).reduced()
    params, batch = shared_params(cfg), batch_np(cfg, s=s)
    loss0, _, g0 = port_grads(cfg, params, batch)
    loss1, _, g1 = port_grads(dataclasses.replace(cfg, remat=True), params,
                              batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1)), name


def test_bf16_products_backward_on_meta():
    """The card's bfloat16 products (``torch.mm(out_dtype=float32)``, an
    op with no derivative of its own) carry their own backward: on
    ``meta`` tensors, shapes and dtypes of the gradients, for ``matmul``'s
    cast and for ``dot_f32``'s float32 result, bare and inside a
    checkpoint (whose saved tensors unpack once)."""
    from repro_torch.models import layers

    for fn, ckpt in itertools.product((layers._MatmulCast, layers._DotF32),
                                      (False, True)):
        out = torch.bfloat16 if fn is layers._MatmulCast else torch.float32
        x = torch.empty((2, 3, 8), dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        w = torch.empty((8, 5), dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        y = layers.remat(fn.apply, x, w) if ckpt else fn.apply(x, w)
        assert y.dtype == out and y.shape == (2, 3, 5)
        dx, dw = torch.autograd.grad(y.sum(), (x, w))
        assert dx.dtype == dw.dtype == torch.bfloat16
        assert dx.shape == x.shape and dw.shape == w.shape
