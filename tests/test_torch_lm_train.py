"""The port's LM training driver held to the JAX package on the CPU: the
data pipeline, the step builders' rules, the train step, the train loop,
the fault drill and the resume.

* ``SyntheticLMData.batch`` equals the JAX package's bit for bit over
  seeds, steps and host splits; the prefetch iterator resumes at
  ``start_step`` and re-raises a batch it failed to build.
* ``choose_accum`` (at ``train_4k``), ``select_optimizer`` and
  ``active_param_count`` equal the JAX package's for all ten full-size
  configs (counted on ``meta`` / ``eval_shape``: nothing allocated).
* ``make_train_step`` runs 3 steps against the JAX package's at accum 1
  and 2, on a dense and an MoE architecture, with SGD at a fixed rate (in
  both packages ``select_optimizer`` is replaced for this): parameters
  within 1e-4 of each leaf's largest entry, losses within 1e-4. AdamW is
  not used here on purpose: at its first steps ``u ≈ sign(g)`` turns any
  near-zero gradient into a full-size difference.
* ``train_loop`` from the JAX package's initial state (carried in through
  ``TrainStep.init_state``) gives the JAX loop's losses within 1e-4 over 5
  steps (AdamW, as ``select_optimizer`` picks).
* The ``fail_at`` drill restarts once and ends on the unfailed run's
  parameters bit for bit; a run resumed from a checkpoint continues the
  uninterrupted run's losses bit for bit.
* The step on a mesh of two slots equals the one-slot step; the loop on
  a (2, 2) mesh equals the one-slot loop, its fault drill restores onto
  the mesh bit for bit, and a resume continues onto a (1, 2) mesh
  (``tests/test_torch_lm_shard.py`` holds the executor itself);
  ``device="cuda"`` without a card raises.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.data import SyntheticLMData as JData
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import build_model as jbuild_model
from repro.optim import constant as jconstant
from repro.optim import sgd as jsgd
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.convert import lm_opt_state_to_torch, lm_params_to_torch
from repro_torch.data import SyntheticLMData, make_batch_iterator
from repro_torch.distributed import elastic
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import constant, optimizers
from test_torch_lm_models import rel, shared_params

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = 1e-4
LR = 0.5            # SGD's fixed rate: large enough that 3 steps move
CPU = make_host_mesh(devices=["cpu"])


# -- data ------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,hosts", [
    (0, 0, 1), (3, 5, 1), (3, 5, 2), (11, 17, 4)])
def test_batches_equal_jax_bit_for_bit(seed, step, hosts):
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, seed=seed)
    ours, theirs = SyntheticLMData(**kw), JData(**kw)
    for host in range(hosts):
        a = ours.batch(step, host_id=host, host_count=hosts)
        b = theirs.batch(step, host_id=host, host_count=hosts)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_iterator_resumes_at_start_step():
    src = SyntheticLMData(vocab_size=256, seq_len=16, global_batch=4, seed=3)
    it = make_batch_iterator(src, start_step=3, device="cpu")
    try:
        got = [next(it) for _ in range(3)]
    finally:
        it.close()
    assert not it._thread.is_alive()
    for i, b in enumerate(got):
        want = src.batch(3 + i)
        for k in ("tokens", "labels"):
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), want[k])


def test_iterator_reraises_a_failed_batch():
    src = SyntheticLMData(vocab_size=256, seq_len=16, global_batch=3)
    it = make_batch_iterator(src, host_count=2, device="cpu")
    try:
        with pytest.raises(ValueError, match="does not split"):
            next(it)
    finally:
        it.close()


# -- step builders' rules at full size ---------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_accum_optimizer_and_active_count_match_jax(name):
    model, jmodel = build_model(get_arch(name)), jbuild_model(JARCHS[name])
    assert steps.choose_accum(model, SHAPES["train_4k"], CPU) == \
        jsteps.choose_accum(jmodel, JSHAPES["train_4k"], jmake_host_mesh())
    assert steps.select_optimizer(model)[1] == \
        jsteps.select_optimizer(jmodel)[1]
    assert steps.active_param_count(model) == \
        jsteps.active_param_count(jmodel)


# -- the train step ------------------------------------------------------------------
@pytest.fixture
def fixed_sgd(monkeypatch):
    """Both packages' ``select_optimizer`` give SGD at rate LR."""
    monkeypatch.setattr(jsteps, "select_optimizer",
                        lambda model, total_steps=0: (
                            jsgd(jconstant(LR)), "sgd"))
    monkeypatch.setattr(steps, "select_optimizer",
                        lambda model, total_steps=0: (
                            optimizers.sgd(constant(LR)), "sgd"))


@pytest.mark.parametrize("name", ["gemma3-4b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(name, accum, fixed_sgd):
    cfg = get_arch(name).reduced()
    params = shared_params(cfg)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=4, seed=5)
    jts = jsteps.make_train_step(JARCHS[name].reduced(), jmake_host_mesh(),
                                 accum=accum, donate=False)
    jbatch = data.batch(0)
    jfn, _ = jts.fn(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jbatch))
    jp = jax.tree.map(jnp.asarray, params)
    js = jts.optimizer.init(jp)
    ts = steps.make_train_step(cfg, CPU, accum=accum)
    assert ts.opt_name == "sgd"
    tp = lm_params_to_torch(params, device="cpu")
    tstate = ts.optimizer.init(tp)
    for k in range(3):
        b = data.batch(k)
        jp, js, jm = jfn(jp, js, {key: jnp.asarray(v) for key, v in b.items()})
        tp, tstate, tm = ts.fn(tp, tstate, {key: torch.from_numpy(v)
                                            for key, v in b.items()})
        assert set(tm) == {"loss", "nll", "aux"}
        for key in tm:
            assert abs(float(tm[key]) - float(jm[key])) <= TOL * max(
                abs(float(jm["loss"])), 1.0), (name, accum, k, key)
        if accum > 1:
            assert float(tm["aux"]) == 0.0 and float(tm["nll"]) == \
                float(tm["loss"])
    got = [t.detach().numpy() for t in tree_leaves(tp)]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    assert len(got) == len(want)
    errs = [rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= TOL, (name, accum, max(errs))


def test_train_step_on_two_slots_raises(fixed_sgd):
    """The two-slot step runs and equals the one-slot step (3 steps of
    SGD at a fixed rate, each parameter leaf within 1e-5 of its largest
    entry); only a mesh without its devices raises. (The name dates from
    when the step refused a mesh of more than one slot.)"""
    cfg = get_arch("gemma3-4b").reduced()
    data = SyntheticLMData(cfg.vocab_size, 16, 4, seed=1)
    with pytest.raises(RuntimeError, match="needs 2 devices"):
        make_mesh((2, 1), ("data", "model"), devices=["cpu"])
    outs = []
    for mesh in (CPU, make_mesh((2, 1), ("data", "model"),
                                devices=["cpu", "cpu"])):
        ts = steps.make_train_step(cfg, mesh)
        params, state = ts.init_state(torch.Generator().manual_seed(0))
        losses = []
        for i in range(3):
            batch = {k: torch.from_numpy(v)
                     for k, v in data.batch(i).items()}
            params, state, metrics = ts.fn(params, state, batch)
            losses.append(float(metrics["loss"]))
        if ts.params_sh is not None:
            params = [elastic.gather(x) for x in elastic.placed_leaves(params)]
        outs.append((losses, tree_leaves(params)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    assert max(rel(a, b) for a, b in zip(outs[1][1], outs[0][1])) <= 1e-5


# -- the loop --------------------------------------------------------------------------
LOOP = dict(steps=5, global_batch=2, seq_len=16, log_every=100)


def t2n_jax(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_loop_matches_jax(monkeypatch):
    name = "starcoder2-15b"
    jcfg = JARCHS[name].reduced()
    jres = jtrain.train_loop(jcfg, jmake_host_mesh(), **LOOP)
    jts = jsteps.make_train_step(jcfg, jmake_host_mesh(), donate=False,
                                 total_steps=LOOP["steps"])
    jp, js = jts.init_state(jax.random.PRNGKey(0))
    start = (lm_params_to_torch(t2n_jax(jp), device="cpu"),
             lm_opt_state_to_torch(t2n_jax(js), device="cpu"))
    monkeypatch.setattr(steps.TrainStep, "init_state",
                        lambda self, generator: start)
    res = train_loop(get_arch(name).reduced(), device="cpu", **LOOP)
    assert res.steps_done == LOOP["steps"] and len(res.losses) == 5
    np.testing.assert_allclose(res.losses, jres.losses, rtol=TOL)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_fail_drill_restarts_once_bit_for_bit(tmp_path):
    cfg = get_arch("starcoder2-15b").reduced()
    kw = dict(LOOP, steps=6, ckpt_every=2, device="cpu")
    full = train_loop(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    failed = train_loop(cfg, ckpt_dir=str(tmp_path / "b"), fail_at=4, **kw)
    assert full.restarts == 0 and failed.restarts == 1
    assert failed.steps_done == 6
    assert failed.losses[-2:] == full.losses[-2:]
    assert _same_bits(failed.state[0], full.state[0])
    assert _same_bits(failed.state[1].inner, full.state[1].inner)


def test_resume_continues_the_losses(tmp_path):
    cfg = get_arch("starcoder2-15b").reduced()
    kw = dict(LOOP, steps=6, ckpt_every=2, device="cpu")
    root = str(tmp_path / "run")
    full = train_loop(cfg, ckpt_dir=root, **kw)
    # the run as if it had stopped after step 2: later checkpoints gone
    for s in (4, 6):
        shutil.rmtree(os.path.join(root, f"step_{s}"))
    resumed = train_loop(cfg, ckpt_dir=root, **kw)
    assert resumed.losses == full.losses[2:]
    assert _same_bits(resumed.state[0], full.state[0])


def test_train_loop_on_a_mesh_drill_and_resume(tmp_path, monkeypatch):
    """``train_loop`` on a (2, 2) CPU mesh (SGD at a fixed rate): the
    uninterrupted run equals the one-slot loop (losses and parameters
    within 1e-5); the ``fail_at`` drill restarts once from a checkpoint
    with specs and ends on the uninterrupted run's parameters bit for
    bit; a resume from step 2 onto a (1, 2) mesh (the surviving slots of
    ``shrink_mesh``) continues the losses and ends within 1e-5."""
    sgd = (optimizers.sgd(constant(0.05)), "sgd")
    monkeypatch.setattr(steps, "select_optimizer",
                        lambda model, total_steps=0: sgd)
    cfg = get_arch("starcoder2-15b").reduced()
    kw = dict(LOOP, steps=6, ckpt_every=2)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    one = train_loop(cfg, device="cpu", **kw)
    full = train_loop(cfg, mesh, ckpt_dir=str(tmp_path / "a"), **kw)
    failed = train_loop(cfg, mesh, ckpt_dir=str(tmp_path / "b"), fail_at=4,
                        **kw)
    for s in (4, 6):
        shutil.rmtree(str(tmp_path / "a" / f"step_{s}"))
    live = elastic.shrink_mesh(mesh, [2, 3])
    small = make_mesh((1, 2), ("data", "model"),
                      devices=list(live.devices.flat[:2]))
    resumed = train_loop(cfg, small, ckpt_dir=str(tmp_path / "a"), **kw)

    def leaves(res):
        return [elastic.gather(x) for x in elastic.placed_leaves(res.state[0])]

    np.testing.assert_allclose(full.losses, one.losses, rtol=1e-5)
    assert max(rel(a, b) for a, b in zip(
        leaves(full), tree_leaves(one.state[0]))) <= 1e-5
    assert full.restarts == 0 and failed.restarts == 1
    assert failed.losses[-2:] == full.losses[-2:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(failed),
                                                 leaves(full)))
    np.testing.assert_allclose(resumed.losses, full.losses[2:], rtol=1e-5)
    assert max(rel(a, b) for a, b in zip(leaves(resumed),
                                         leaves(full))) <= 1e-5


def test_train_loop_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(get_arch("starcoder2-15b").reduced(), **LOOP)
