"""The port's LM modules one by one, held to the JAX package on the CPU:
``attention_train`` (banded local, masked global, cross), ``mla_train``,
``moe_apply`` with drops (capacity factor 1.0 over two router groups, so
choices are dropped; the reduced configs are drop-free),
``_ssd_chunk_scan``, ``mlstm_train`` and ``slstm_train``, each within
1e-4 of the largest magnitude at float32; ``matmul`` in bfloat16 against
the JAX package's (float32 accumulation, cast back); and the port's
``init_params`` against the JAX package's ``init_params(PRNGKey)`` leaf
by leaf, in distribution (constants equal, truncated normals of the same
scale and bound).

Parameters are the port's seeded draw (1-D leaves shifted by seeded numpy
noise), carried to JAX as numpy arrays and to the port through
``lm_params_to_torch``; inputs are numpy draws from a seed; the JAX call
is jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import MoEConfig, get_arch
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import attention, build_model, layers, moe, ssm
from repro_torch.models.layers import Init
from repro_torch.models.tree import tree_map

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = 1e-4          # relative to the largest magnitude, float32
B, S = 2, 32


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _numpy_tree(init_fn, seed):
    gen = torch.Generator().manual_seed(seed)
    return t2n(init_fn(Init(gen, torch.device("cpu"))))


def _shifted(tree, seed):
    rng = np.random.default_rng(seed)
    return tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, tree)


def _attention_case(kind):
    d, h, hkv, dh = 64, 4, 2, 16
    params = _shifted(_numpy_tree(lambda i: attention.init_gqa(
        i, d, h, hkv, dh, torch.float32, use_bias=True), 3), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(n_heads=h, n_kv=hkv, d_head=dh, q_chunk=8)
    args = (params, x, pos)
    if kind == "banded":
        kw.update(rope_theta=10_000.0, window=8, use_qk_norm=True)
    elif kind == "global":
        kw.update(rope_theta=1e6)
    else:  # cross: 12 source positions, no mask, no rope
        xkv = rng.standard_normal((B, 12, d)).astype(np.float32)
        kvp = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12)).copy()
        kw.update(rope_theta=None, causal=False)
        return (attention.attention_train, jattn.attention_train, args,
                dict(kw, x_kv=xkv, kv_positions=kvp))
    return attention.attention_train, jattn.attention_train, args, kw


def _mla_case():
    mla = get_arch("deepseek-v2-236b").reduced().mla
    params = _numpy_tree(
        lambda i: attention.init_mla(i, 64, 4, mla, torch.float32), 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return (attention.mla_train, jattn.mla_train, (params, x, pos),
            dict(n_heads=4, mla=mla, q_chunk=8))


def _moe_case():
    # capacity factor 1.0 over two router groups of 16 tokens: capacity
    # ceil(16 * 2 / 8) = 4 per expert, so choices are dropped
    mcfg = MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                     capacity_factor=1.0, router_group_size=16)
    params = _numpy_tree(
        lambda i: moe.init_moe(i, 64, mcfg, torch.float32), 7)
    x = np.random.default_rng(8).standard_normal((B, S, 64)).astype(
        np.float32)
    return moe.moe_apply, jmoe.moe_apply, (params, x, mcfg), {}


def _ssd_case():
    rng = np.random.default_rng(9)
    h, p, n = 4, 8, 8
    xh = rng.standard_normal((B, S, h, p)).astype(np.float32)
    bm = rng.standard_normal((B, S, n)).astype(np.float32)
    cm = rng.standard_normal((B, S, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, h)) - 1.0)).astype(
        np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    return ssm._ssd_chunk_scan, jssm._ssd_chunk_scan, \
        (xh, bm, cm, dt, a, 8), {}


def _xlstm_case(kind):
    init = ssm.init_mlstm if kind == "mlstm" else ssm.init_slstm
    params = _numpy_tree(lambda i: init(i, 64, 4, torch.float32), 10)
    x = np.random.default_rng(11).standard_normal((B, S, 64)).astype(
        np.float32)
    if kind == "mlstm":
        return ssm.mlstm_train, jssm.mlstm_train, (params, x, 4), \
            dict(chunk=8)
    return ssm.slstm_train, jssm.slstm_train, (params, x, 4), {}


MODULE_CASES = {
    "attention_banded": lambda: _attention_case("banded"),
    "attention_global": lambda: _attention_case("global"),
    "attention_cross": lambda: _attention_case("cross"),
    "mla_train": _mla_case,
    "moe_apply_drops": _moe_case,
    "ssd_chunk_scan": _ssd_case,
    "mlstm_train": lambda: _xlstm_case("mlstm"),
    "slstm_train": lambda: _xlstm_case("slstm"),
}


def _to_jax(a):
    if isinstance(a, np.ndarray):
        return jnp.asarray(a)
    if isinstance(a, dict):
        return {k: _to_jax(v) for k, v in a.items()}
    return a


def _to_port(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a)
    if isinstance(a, dict):
        return lm_params_to_torch(a, device="cpu")
    return a


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_matches_jax(case):
    fn, jfn, args, kw = MODULE_CASES[case]()
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    jargs = [_to_jax(a) for a in args]
    traced = [i for i, a in enumerate(args)
              if isinstance(a, (np.ndarray, dict))]

    def call(*xs):
        full = list(jargs)
        for i, x in zip(traced, xs[:len(traced)]):
            full[i] = x
        return jfn(*full, **static,
                   **dict(zip(arrays, xs[len(traced):])))

    want = jax.jit(call)(*[jargs[i] for i in traced],
                         *[jnp.asarray(v) for v in arrays.values()])
    got = fn(*[_to_port(a) for a in args], **static,
             **{k: torch.from_numpy(v) for k, v in arrays.items()})
    if case == "moe_apply_drops":
        (out, aux), (jout, jaux) = got, want
        assert rel(out.numpy(), jout) <= TOL
        assert abs(float(aux) - float(jaux)) <= TOL
        # the drop path ran: a drop-free capacity gives another output
        mcfg = args[2]
        free, _ = moe.moe_apply(_to_port(args[0]), torch.from_numpy(args[1]),
                                dataclasses.replace(mcfg,
                                                    capacity_factor=8.0))
        assert rel(out.numpy(), free.numpy()) > 1e-3
        return
    assert got.shape == want.shape
    assert rel(got.numpy(), np.asarray(want)) <= TOL, case


def test_bf16_matmul_accumulates_in_float32_as_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 48)) / 16).astype(np.float32)
    want = np.asarray(jlayers.matmul(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(w, jnp.bfloat16)))
    got = layers.matmul(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    want = want.astype(np.float32)
    # one float32 sum each side, rounded once to bfloat16: at most one
    # bfloat16 step (at most 2^-7 of the value) apart where the sums
    # straddle a rounding boundary
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    assert np.mean(got == want) > 0.99


def _arch_init(name):
    jmodel = jbuild_model(JARCHS[name].reduced())
    return (jmodel.init_params,
            lambda gen: build_model(get_arch(name).reduced()).init_params(gen))


def _module_init(jinit, init, *args):
    return (lambda key: jinit(key, *args, jnp.float32),
            lambda gen: init(Init(gen, torch.device("cpu")), *args,
                             torch.float32))


# between them every init helper runs: GQA, MLPs, norms and the
# embedding in each architecture; mLSTM and sLSTM (xlstm); Mamba-2 and
# the shared attention block (zamba2); MLA and MoE at the reduced
# deepseek-v2's shapes, module by module (its whole init compiles ~20 s)
_DS = get_arch("deepseek-v2-236b").reduced()
INIT_CASES = {
    "xlstm-1.3b": lambda: _arch_init("xlstm-1.3b"),
    "zamba2-7b": lambda: _arch_init("zamba2-7b"),
    "mla": lambda: _module_init(jattn.init_mla, attention.init_mla,
                                _DS.d_model, _DS.n_heads, _DS.mla),
    "moe": lambda: _module_init(jmoe.init_moe, moe.init_moe, _DS.d_model,
                                _DS.moe),
}


def _leaves(tree):
    return [np.asarray(a, np.float64)
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_init_params_matches_jax_in_distribution(name):
    """Leaves the JAX package draws identically under two keys are
    constants: the port's equal them. The others are truncated normals:
    the port's have the same spread (std within 4/sqrt(n), about six
    standard errors) and the same bound (max |x| within 5 % of the JAX
    pair's)."""
    jinit, init = INIT_CASES[name]()
    jinit = jax.jit(jinit)
    j0 = jinit(jax.random.PRNGKey(0))
    j1 = jinit(jax.random.PRNGKey(1))
    port = t2n(init(torch.Generator().manual_seed(0)))
    assert jax.tree_util.tree_structure(port) == \
        jax.tree_util.tree_structure(j0)
    n_random = 0
    for k, (p, a, b) in enumerate(zip(_leaves(port), _leaves(j0),
                                      _leaves(j1))):
        assert p.shape == a.shape, (name, k)
        if np.array_equal(a, b):
            np.testing.assert_array_equal(p, a, err_msg=f"{name} leaf {k}")
            continue
        n_random += 1
        n = p.size
        pair = np.concatenate([a.ravel(), b.ravel()])
        assert abs(p.std() / pair.std() - 1.0) <= 4.0 / np.sqrt(n), (name, k)
        assert abs(p.mean() - pair.mean()) <= 6.0 * pair.std() / np.sqrt(n)
        if n >= 256:
            bound = np.abs(pair).max()
            assert 0.95 * bound <= np.abs(p).max() <= 1.05 * bound, (name, k)
    assert n_random > 0
