"""The port's int8 error-feedback all-reduce held to the JAX package's.

* ``_quantize`` bit for bit against the JAX package's.
* ``compressed_psum`` over 8 slots of equal gradients against the JAX
  package's on its one CPU device (a one-slot mesh): the mean of equal
  gradients is the same, bit for bit, and so are the carries.
* The bounds of ``tests/test_compression.py``: one step within max|g|/127
  of the gradient, two steps of a constant gradient averaging to within
  0.75 of that (error feedback).
* Distinct gradients per slot: the mean within scale/2 of the plain mean
  (scale the shared max over the slots / 127), and the carries holding
  each slot's residual.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcompression
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.distributed import compression
from repro_torch.launch.mesh import make_mesh

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

SLOTS = 8


def grads(seed, shape=(16, 32)):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=shape).astype(np.float32),
            "b": (rng.normal(size=shape[-1:]) * 1e-3).astype(np.float32)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_bit_for_bit(seed):
    x = grads(seed)["w"] * 10.0 ** (seed - 2)
    q, scale = compression._quantize(torch.from_numpy(x))
    jq, jscale = jcompression._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(scale.item()) == np.float32(jscale)


@pytest.mark.parametrize("seed", [0, 5])
def test_equal_slots_match_jax_one_device(seed):
    g = grads(seed)
    mesh = make_mesh((SLOTS,), ("data",), devices=["cpu"] * SLOTS)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    err = [compression.make_error_feedback_state(tg) for _ in range(SLOTS)]
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jerr = jcompression.make_error_feedback_state(jg)
    jmesh = jmake_mesh((1,), ("data",))
    for _ in range(2):      # the second step carries the first's residual
        mean, err = compression.compressed_psum([tg] * SLOTS, err, mesh)
        jmean, jerr = jcompression.compressed_psum(jg, jerr, jmesh)
        for k in g:
            np.testing.assert_array_equal(mean[k].numpy(),
                                          np.asarray(jmean[k]))
            for e in err:
                np.testing.assert_array_equal(e[k].numpy(),
                                              np.asarray(jerr[k]))


def test_error_feedback_bounds():
    g = {"w": torch.from_numpy(grads(0)["w"])}
    err = [compression.make_error_feedback_state(g) for _ in range(SLOTS)]
    mean, err2 = compression.compressed_psum([g] * SLOTS, err)
    bound = float(g["w"].abs().max()) / 127.0 + 1e-9
    assert float((mean["w"] - g["w"]).abs().max()) <= bound * 1.01
    mean2, _ = compression.compressed_psum([g] * SLOTS, err2)
    two_step = (mean["w"] + mean2["w"]) / 2
    assert float((two_step - g["w"]).abs().max()) <= bound * 0.75
    assert err[0]["w"].dtype == torch.float32
    assert err[0]["w"].shape == g["w"].shape


@pytest.mark.parametrize("seed", [0, 7])
def test_distinct_slots_within_half_a_step_of_the_mean(seed):
    per = [{k: torch.from_numpy(v) for k, v in grads(seed + i).items()}
           for i in range(SLOTS)]
    err = [compression.make_error_feedback_state(per[0])
           for _ in range(SLOTS)]
    mean, new_err = compression.compressed_psum(per, err)
    for k in per[0]:
        stack = torch.stack([p[k] for p in per])
        scale = float(stack.abs().max()) / 127.0 + 1e-12
        plain = stack.mean(0)
        assert float((mean[k] - plain).abs().max()) <= scale / 2 + 1e-7
        # each carry is its slot's residual: g = dequantized + carry
        for p, e in zip(per, new_err):
            q = torch.round((p[k] - e[k]) / scale)
            assert float((q * scale + e[k] - p[k]).abs().max()) <= 1e-6
            assert float(e[k].abs().max()) <= scale / 2 + 1e-7


def test_slot_count_must_match_the_mesh():
    g = {"w": torch.ones(4)}
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="data slots"):
        compression.compressed_psum([g] * 3, [g] * 3, mesh)
