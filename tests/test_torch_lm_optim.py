"""The port's optimizers and schedules (``repro_torch.optim``) held to the
JAX package's (``repro.optim``) on the CPU.

Each optimizer runs 5 steps, port against JAX, from the same bfloat16
parameters on the same gradient trees (numpy draws from a seed; the
parameters rounded to bfloat16, the gradients to multiples of 2^-6, so
that both sides read the same values): ``sgd`` with
and without momentum, ``adamw`` with weight decay, and ``adafactor`` with
a factored leaf (both trailing dims >= 128), a stacked factored leaf and
unfactored ones. Parameters (in whatever dtype the JAX package returns
them: its ``sgd`` widens bfloat16 to float32) and every state leaf agree
within 1e-6 of the leaf's largest entry, and the step counts equal.
``clip_by_global_norm``, ``global_norm`` and the three schedules agree
within 1e-6; the fits' in-place ``AdamW`` equals the tree ``adamw`` over
the same list of leaves. The JAX optimizers run op by op (not jitted), as
the port does.

Why the gradient grid: the global norm (the clip) sums every squared
entry. On gradients of 2^-6 steps every such sum is exact in float32 on
both sides. On free float32 draws the JAX package's CPU reduction of a
33k-entry leaf is 3e-6 (relative) off the exact sum and torch's 1e-8,
and that, not the optimizers, would set the difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.optim import optimizers

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = 1e-6
STEPS = 5
SHAPES = {"w": (128, 160), "stack": (2, 130, 128), "b": (160,),
          "blocks": [{"k": (16, 200)}, {"k": (16, 200)}]}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


GRID = 2.0 ** -6      # the gradients' step


def bf16_tree(seed, scale, grid=None):
    """A tree of SHAPES drawn from `seed` (rounded to multiples of `grid`
    where given), rounded to bfloat16, as numpy float32 (exact)."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        a = scale * rng.standard_normal(shape)
        if grid:
            a = np.round(a / grid) * grid
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float(
            ).numpy()

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return draw(t)
    return walk(SHAPES)


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def to_port(tree):
    return tree_map(lambda a: torch.from_numpy(a).bfloat16(), tree)


def j2n(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def p2n(tree):
    return [t.float().numpy() for t in tree_leaves(tree)]


def assert_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        assert rel(g, w) <= TOL, (what, i, rel(g, w))


def run_both(jopt, opt):
    """STEPS updates of each; returns (JAX params, state), (port params,
    state)."""
    params = bf16_tree(0, 1.0)
    jp, tp = to_jax(params), to_port(params)
    js, ts = jopt.init(jp), opt.init(tp)
    for k in range(STEPS):
        g = bf16_tree(10 + k, 0.1, GRID)
        jp, js = jopt.update(to_jax(g), js, jp)
        tp, ts = opt.update(to_port(g), ts, tp)
        assert int(ts.step) == int(js.step) == k + 1
        assert [t.dtype for t in tree_leaves(tp)] == [
            torch.float32 if x.dtype == jnp.float32 else torch.bfloat16
            for x in jax.tree_util.tree_leaves(jp)]
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["plain", "momentum"])
def test_sgd_matches_jax(momentum):
    (jp, js), (tp, ts) = run_both(
        joptim.sgd(joptim.constant(0.05), momentum),
        optimizers.sgd(optim.constant(0.05), momentum))
    assert_close(p2n(tp), j2n(jp), "params")
    if momentum:
        assert_close(p2n(ts.inner), j2n(js.inner), "velocity")
    else:
        assert ts.inner is None and js.inner is None


def test_adamw_matches_jax():
    (jp, js), (tp, ts) = run_both(
        joptim.adamw(joptim.linear_warmup_cosine(1e-2, 2, 10),
                     weight_decay=0.1),
        optimizers.adamw(optim.linear_warmup_cosine(1e-2, 2, 10),
                         weight_decay=0.1))
    assert_close(p2n(tp), j2n(jp), "params")
    for key in ("m", "v"):
        assert_close(p2n(ts.inner[key]), j2n(js.inner[key]), key)


def test_adafactor_matches_jax():
    (jp, js), (tp, ts) = run_both(
        joptim.adafactor(joptim.constant(1e-2)),
        optimizers.adafactor(optim.constant(1e-2)))
    assert_close(p2n(tp), j2n(jp), "params")
    # the factored leaves keep rows and columns, the others a full moment
    assert set(ts.inner["w"]) == {"vr", "vc"}
    assert set(ts.inner["stack"]) == {"vr", "vc"}
    assert ts.inner["stack"]["vr"].shape == (2, 130)
    assert set(ts.inner["b"]) == {"v"} and set(ts.inner["blocks"][0]["k"]) \
        == {"v"}
    assert jax.tree_util.tree_structure(js.inner) == \
        jax.tree_util.tree_structure(tree_map(lambda t: 0, ts.inner))
    assert_close(p2n(ts.inner), j2n(js.inner), "moments")


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_and_global_norm_match_jax(max_norm):
    g = bf16_tree(3, 0.1, GRID)
    jg, jn = joptim.clip_by_global_norm(to_jax(g), max_norm)
    tg, tn = optim.clip_by_global_norm(to_port(g), max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    assert abs(float(optim.global_norm(to_port(g))) - float(
        joptim.global_norm(to_jax(g)))) <= TOL * float(jn)
    assert [t.dtype for t in tree_leaves(tg)] == [torch.float32] * 5
    assert_close(p2n(tg), j2n(jg), "clipped")


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine_decay", (3e-4, 10)),
    ("linear_warmup_cosine", (3e-4, 3, 10)),
])
def test_schedules_match_jax(name, args):
    jfn, fn = getattr(joptim, name)(*args), getattr(optim, name)(*args)
    for step in range(14):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= TOL * 3e-4, (name, step)


def test_inplace_adamw_equals_tree_adamw():
    """The fits' ``AdamW`` (a list, in place, state on the object) against
    the tree ``adamw`` on the same leaves, float32: equal bit for bit."""
    sched = optim.linear_warmup_cosine(1e-2, 2, 10)
    leaves = tree_leaves(tree_map(torch.from_numpy, bf16_tree(0, 1.0)))
    fits = [t.clone() for t in leaves]
    tree = [t.clone() for t in leaves]
    a, opt = optim.AdamW(sched, weight_decay=0.1), optimizers.adamw(
        sched, weight_decay=0.1)
    state = opt.init(tree)
    for k in range(STEPS):
        g = tree_leaves(tree_map(torch.from_numpy, bf16_tree(10 + k, 0.1, GRID)))
        a.update(g, fits)
        tree, state = opt.update(g, state, tree)
    assert int(a.step) == int(state.step) == STEPS
    for x, y in zip(fits, tree):
        assert torch.equal(x, y)
    for x, y in zip(a.m + a.v, state.inner["m"] + state.inner["v"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("which", ["sgd", "adamw", "adafactor"])
def test_opt_state_carries_from_jax(which):
    """A JAX state after 2 steps, carried across (``lm_opt_state_to_torch``)
    with its parameters, continues 3 more steps as the JAX one does."""
    from repro_torch.convert import lm_opt_state_to_torch

    jopt, opt = {
        "sgd": (joptim.sgd(joptim.constant(0.05), 0.9),
                optimizers.sgd(optim.constant(0.05), 0.9)),
        "adamw": (joptim.adamw(joptim.constant(1e-2)),
                  optimizers.adamw(optim.constant(1e-2))),
        "adafactor": (joptim.adafactor(joptim.constant(1e-2)),
                      optimizers.adafactor(optim.constant(1e-2))),
    }[which]
    jp = to_jax(bf16_tree(0, 1.0))
    js = jopt.init(jp)
    for k in range(STEPS):
        g = bf16_tree(10 + k, 0.1, GRID)
        if k == 2:
            host = jax.tree.map(np.asarray, (jp, js))
            tp = tree_map(lambda a: torch.from_numpy(
                a.astype(np.float32)).to(
                    torch.bfloat16 if a.dtype.name == "bfloat16"
                    else torch.float32), host[0])
            ts = lm_opt_state_to_torch(host[1], device="cpu")
            assert int(ts.step) == 2 and ts.step.dtype == torch.int32
            assert_close(p2n(ts.inner), j2n(js.inner), "carried")
        if k >= 2:
            tp, ts = opt.update(to_port(g), ts, tp)
        jp, js = jopt.update(to_jax(g), js, jp)
    assert int(ts.step) == int(js.step) == STEPS
    assert_close(p2n(tp), j2n(jp), "params")
    assert_close(p2n(ts.inner), j2n(js.inner), "state")
