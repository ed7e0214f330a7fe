"""The port's LM backward held to the JAX package on the CPU: the MoE,
SSM and hybrid architectures, as ``test_torch_lm_grad.py`` holds the
attention and dense ones, with its checks (the two files split the JAX
compiles between the test workers).

For each reduced architecture at float32, the port's ``loss_fn`` and
``torch.autograd.grad`` of it against ``jax.value_and_grad(loss_fn,
has_aux=True)`` on the same parameters and batch: the loss within 1e-4 of
its magnitude, every gradient leaf within 1e-4 of that leaf's largest
entry. With ``remat=True`` (the layer groups, and inside them the MoE
router groups and the scan chunks, checkpointed) the port's gradients
equal its ``remat=False`` ones bit for bit.
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
from test_torch_lm_grad import TOL, check_grads, port_grads
from test_torch_lm_models import batch_np, shared_params

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

NAMES = ["deepseek-v2-236b", "llama4-maverick-400b-a17b", "xlstm-1.3b",
         "zamba2-7b"]
# MLA+MoE and MoE at 128 tokens (two router groups), xLSTM, Mamba+shared
# attention at 64 (four scan chunks)
REMAT = [("deepseek-v2-236b", 128), ("llama4-maverick-400b-a17b", 128),
         ("xlstm-1.3b", 64), ("zamba2-7b", 64)]


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
