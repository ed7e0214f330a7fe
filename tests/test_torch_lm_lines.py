"""The LM batch over the data axes: each line (data index d with its
model slots) runs its own rows, and the loss's global statistics are
reduced across the lines; held on the CPU.

* Against the JAX package: the port's loss and gradients on a (4, 1)
  mesh of CPU slots, one row per line, against ``jax.value_and_grad(
  loss_fn)`` on the same numpy parameters and batch, within 1e-5, for an
  MoE architecture (llama4, reduced) and a dense one (starcoder2). The
  last line's labels are partly masked, so a mean of the lines' means
  would miss the global masked mean; the lines route their tokens to
  different experts, so a mean of the lines' load balances would miss
  the product of the global means (both asserted on the seeded batch).
* The accum-2 step on (4, 1), 8 rows: each microbatch of 4 rows split
  over the 4 lines, against the one-slot step (SGD), within 1e-5.
* On ``meta`` slots, a (4, 2) train step and prefill under
  ``op_cost.OpCounter``: the home owner allocates no tensor whose
  leading dim is the global batch, and each line's activation bytes are
  a quarter of those of the one line of a (1, 2) mesh, where the whole
  batch's activations sit on one device (the home's, before the lines).
* ``make_batch_iterator(shardings=)`` puts each line's rows on its
  slots, one tensor per line (at accum 1, and in the microbatch layout
  at accum 2); ``train_loop`` on (2, 2) takes its batches so, at the start
  and after its fault drill's restart, and ends on the uninterrupted
  run's losses.

``tests/test_torch_lm_shard.py`` holds the ten reduced architectures on
(2, 2), (1, 4), (1, 8), (4, 1) and (4, 2) to one slot.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch, input_specs
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import lm_params_to_torch
from repro_torch.data import SyntheticLMData
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.distributed import elastic
from repro_torch.distributed.sharding import BatchShardings
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.optim import constant, optimizers
from repro_torch.roofline.op_cost import HOME, OpCounter
from test_torch_lm_models import rel, shared_params

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 1e-5


def mesh_of(shape, device="cpu"):
    return make_mesh(shape, ("data", "model"),
                     devices=[device] * int(np.prod(shape)))


def masked_batch(cfg, rows=4, seq=32, seed=5) -> dict:
    """`rows` rows of seeded tokens, the last row's labels masked past
    position 8."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[-1, 8:] = -1
    return {"tokens": tok, "labels": lab}


class LineStats:
    """Records each ``moe._dispatch_chunk``'s (density, prob_mass), in
    the order the lines run them."""

    def __init__(self, monkeypatch):
        self.moe = []
        inner = moe._dispatch_chunk

        def chunk(*a):
            out, st = inner(*a)
            self.moe.append(tuple(t.detach() for t in st[:2]))
            return out, st

        monkeypatch.setattr(moe, "_dispatch_chunk", chunk)


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "starcoder2-15b"])
def test_lines_equal_the_jax_packages_grads(name, monkeypatch):
    cfg = get_arch(name).reduced()
    params = shared_params(cfg)
    batch = masked_batch(cfg)
    jm = jbuild_model(JARCHS[name].reduced())
    (jloss, _), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ts = steps.make_train_step(cfg, mesh_of((4, 1)))
    placed = ts.params_sh.place(lm_params_to_torch(params, device="cpu"))
    rec = LineStats(monkeypatch)
    loss, _, grads = ts.executor.grads(
        ts.model.loss_fn, placed,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    got = [elastic.gather(x) for x in elastic.placed_leaves(grads)]
    for g, w in zip(got, jax.tree_util.tree_leaves(jgrads)):
        assert rel(g.numpy(), np.asarray(w)) <= TOL, name

    # the global masked mean is not the mean of the lines' means
    lab = batch["labels"]
    lines = [(lab[d] >= 0).sum() for d in range(4)]
    assert len(set(lines)) > 1
    if cfg.moe is None:
        return
    # the lines run one after another (no remat in the reduced config:
    # no recompute records twice): per MoE layer the lines route apart,
    # and the lines' own load balances would move the loss by more than
    # the tolerance
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n = len(rec.moe) // 4
    assert n > 0 and len(rec.moe) == 4 * n and not cfg.remat
    gap = 0.0
    for j in range(n):
        dens = torch.stack([rec.moe[d * n + j][0] for d in range(4)])
        mass = torch.stack([rec.moe[d * n + j][1] for d in range(4)])
        assert not all(torch.equal(dens[0], x) for x in dens[1:])
        glob = e * (dens.mean(0) / k * mass.mean(0)).sum()
        apart = (e * (dens / k * mass).sum(-1)).mean()
        gap += float(glob - apart) * 1e-2
    assert abs(gap) > TOL * abs(float(loss))


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "gemma3-4b",
                                  "starcoder2-15b"])
def test_accum2_on_four_lines_matches_one_slot(name):
    cfg = get_arch(name).reduced()
    host = SyntheticLMData(cfg.vocab_size, 32, 8, seed=3).batch(0)
    host["labels"][5, 4:] = -1
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    sgd = (optimizers.sgd(constant(0.5)), "sgd")
    outs = []
    for mesh in (make_host_mesh(devices=["cpu"]), mesh_of((4, 1))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, "select_optimizer",
                       lambda model, total_steps=0: sgd)
            ts = steps.make_train_step(cfg, mesh, accum=2)
        p = tree_map(torch.clone, params)
        state = ts.optimizer.init(p)
        if ts.params_sh is not None:
            p, state = ts.params_sh.place(p), ts.opt_sh.place(state)
            # the pipeline's placement: each line's rows of both
            # microbatches on its own slots
            b = ts.batch_shardings(batch).place(batch)
        else:
            b = batch
        new, _, metrics = ts.fn(p, state, b)
        outs.append((float(metrics["loss"]),
                     [elastic.gather(x) for x in elastic.placed_leaves(new)]
                     if ts.params_sh is not None else tree_leaves(new)))
    assert abs(outs[1][0] - outs[0][0]) <= TOL * abs(outs[0][0])
    assert max(rel(a.numpy(), b.numpy())
               for a, b in zip(outs[1][1], outs[0][1])) <= TOL


class ShapeCounter(OpCounter):
    """``OpCounter`` that also sums, per owner, the bytes of the storages
    it allocates by the leading dim of the tensor allocating them."""

    def __init__(self):
        super().__init__()
        self.lead: dict = {}

    def _allocate(self, t, who, seen):
        key = t.untyped_storage()._cdata
        new = key not in seen and key not in self._storages
        super()._allocate(t, who, seen)
        if new and t.ndim:
            k = (who, t.shape[0])
            self.lead[k] = self.lead.get(k, 0) + t.untyped_storage().nbytes()


def _counted(kind, shape, rows, seq):
    cfg = get_arch("starcoder2-15b").reduced()
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["meta"] * int(np.prod(shape)))
    specs = input_specs(cfg, ShapeCell(kind, seq, rows, kind))
    if kind == "train":
        ts = steps.make_train_step(cfg, mesh)
        p = ts.model.params_spec()
        fn = ts.fn
        args = (ts.params_sh.place(p), ts.opt_sh.place(ts.optimizer.init(p)),
                ts.batch_shardings(specs).place(specs))
    else:
        model, p_sh, fn_for = steps.make_prefill_step(cfg, mesh)
        fn, b_sh = fn_for(specs)
        args = (p_sh.place(model.params_spec()), b_sh.place(specs))
    with ShapeCounter() as c:
        fn(*args)
    return c


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_lines_hold_their_rows_on_meta(kind):
    """28 rows of 32 tokens: a line of (4, 2) holds 7 rows, the one line
    of (1, 2) all 28 (neither 7 nor 28, nor their tokens, is a width of
    the reduced architecture)."""
    rows, seq = 28, 32
    c = _counted(kind, (4, 2), rows, seq)
    assert not any(who == HOME and n in (rows, rows * seq)
                   for who, n in c.lead)

    def line(counter, d, n, m_size=2):
        return sum(counter.lead.get(((d, m), k), 0)
                   for m in range(m_size) for k in (n, n * seq))

    whole = line(_counted(kind, (1, 2), rows, seq), 0, rows)
    assert whole > 0
    for d in range(4):
        assert 4 * line(c, d, rows // 4) == whole


def test_iterator_places_each_lines_rows():
    data = SyntheticLMData(97, 16, 8, seed=2)
    mesh = mesh_of((2, 2))
    want = data.batch(3)
    tree = {k: torch.from_numpy(v) for k, v in want.items()}
    for accum in (1, 2):
        sh = BatchShardings(tree, mesh, accum=accum)
        it = make_batch_iterator(data, start_step=3, device="cpu",
                                 shardings=sh)
        try:
            got = next(it)
        finally:
            it.close()
        for k, pl in got.items():
            assert isinstance(pl, elastic.Placed) and pl.mesh is mesh
            w = want[k].reshape((accum, 8 // accum, 16) if accum > 1
                                else (8, 16))
            for d in range(2):
                blk = pl[2 * d]
                assert pl[2 * d + 1] is blk        # the line's slots share
                rows = (w[:, 2 * d:2 * d + 2] if accum > 1
                        else w[4 * d:4 * d + 4])
                assert np.array_equal(blk.numpy(), rows)
            assert torch.equal(elastic.gather(pl),
                               torch.from_numpy(w))


def test_train_loop_places_its_batches_across_a_drill(tmp_path,
                                                      monkeypatch):
    sgd = (optimizers.sgd(constant(0.05)), "sgd")
    monkeypatch.setattr(steps, "select_optimizer",
                        lambda model, total_steps=0: sgd)
    seen = []
    inner = train.make_batch_iterator

    def spy(*a, **kw):
        seen.append(kw.get("shardings"))
        return inner(*a, **kw)

    monkeypatch.setattr(train, "make_batch_iterator", spy)
    cfg = get_arch("starcoder2-15b").reduced()
    kw = dict(steps=4, global_batch=4, seq_len=16, ckpt_every=2,
              log_every=100, device="cpu")
    mesh = mesh_of((2, 2))
    full = train.train_loop(cfg, mesh, ckpt_dir=str(tmp_path / "a"), **kw)
    failed = train.train_loop(cfg, mesh, ckpt_dir=str(tmp_path / "b"),
                              fail_at=3, **kw)
    assert len(seen) == 3 and all(isinstance(s, BatchShardings)
                                  for s in seen)
    assert failed.restarts == 1 and failed.losses[-1:] == full.losses[-1:]
    assert failed.losses[:3] == full.losses[:3]
