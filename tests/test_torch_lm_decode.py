"""The port's one-token decode held to the JAX package on the CPU.

* ``serve_step`` against the JAX ``serve_step`` over 16 steps, the logits
  of every step and the carried cache after the last, for each cache
  mechanism ``tests/test_decode_consistency.py`` covers: gemma3-4b (ring
  buffer + global cache), deepseek-v2 (MLA latent), zamba2 (mamba2 state
  + shared attention), xlstm (mLSTM/sLSTM states) and whisper (cross
  cache); and the port's decode against its own teacher-forced prefill
  (argmax equal, normalized logits within 5e-2, as the JAX package's
  decode-consistency test requires).
* The ring buffer wrapping: 24 steps through a window of 8.
* Batched rows at different positions do not interfere.

Shared parameters as in ``test_torch_lm_models.py``: the port's seeded
draw, carried to JAX as numpy arrays; the JAX step jitted once per case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_arch
from repro_torch.convert import lm_cache_to_torch, lm_params_to_torch
from repro_torch.models import build_model
from repro_torch.models.tree import tree_map

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

TOL = 1e-4          # relative to the largest magnitude, float32
TF_TOL = 5e-2       # decode against teacher forcing (normalized logits)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def normalized(x):
    return (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True)
                                               + 1e-6)


def shared_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    params = tree_map(lambda t: t.numpy(),
                      build_model(cfg).init_params(gen))
    rng = np.random.default_rng(seed)
    return tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, params)


def decode_both(name, b, s, seed):
    """Decode `s` seeded tokens through both packages' serve_step from the
    same parameters. Returns (port model, port params, tokens, extra
    prefill inputs, port logits per step, JAX logits per step, port
    cache, JAX cache as numpy)."""
    cfg = get_arch(name).reduced()
    model, jmodel = build_model(cfg), jbuild_model(JARCHS[name].reduced())
    params = shared_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    p = lm_params_to_torch(params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    cache = model.init_cache(b, s, device="cpu")
    jcache = jmodel.init_cache(b, s)
    extra = {}
    if cfg.encoder is not None:
        enc = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        extra["enc_embeds"] = enc
        model.prepare_cross_cache(p, cache, torch.from_numpy(enc))
        jcache = jmodel.prepare_cross_cache(jp, jcache, jnp.asarray(enc))
    step = jax.jit(jmodel.serve_step)
    got, want = [], []
    for i in range(s):
        pos = np.full((b,), i, np.int32)
        got.append(model.serve_step(p, cache, torch.from_numpy(toks[:, i:i + 1]),
                                    torch.from_numpy(pos)).numpy())
        logits, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                              jnp.asarray(pos))
        want.append(np.asarray(logits))
    jcache = jax.tree.map(np.asarray, jcache)
    return model, p, toks, extra, got, want, cache, jcache


@pytest.mark.parametrize("name", ["gemma3-4b", "deepseek-v2-236b",
                                  "zamba2-7b", "xlstm-1.3b", "whisper-base"])
def test_serve_step_matches_jax_over_16_steps(name):
    model, p, toks, extra, got, want, cache, jcache = decode_both(
        name, b=2, s=16, seed=0)
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) <= TOL, (name, i)
    # the carried cache, leaf for leaf, in the JAX package's layout
    carried = tree_map(lambda t: t.numpy(),
                       lm_cache_to_torch(jcache, device="cpu"))
    mine = tree_map(lambda t: t.numpy(), cache)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(carried)
    for a, w in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(carried)):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert rel(a, w) <= TOL, name
    # decode against the teacher-forced prefill at the last position
    batch = {"tokens": torch.from_numpy(toks)}
    batch.update({k: torch.from_numpy(v) for k, v in extra.items()})
    full = model.prefill_fn(p, batch).numpy()
    assert (got[-1].argmax(-1) == full.argmax(-1)).all(), name
    np.testing.assert_allclose(normalized(got[-1]), normalized(full),
                               rtol=TF_TOL, atol=TF_TOL)


def test_ring_buffer_wraps():
    """24 steps through gemma3-4b's reduced window of 8: the local
    layers' ring buffers wrap twice; every step matches the JAX package,
    and the last matches teacher forcing."""
    model, p, toks, _, got, want, cache, _ = decode_both(
        "gemma3-4b", b=1, s=24, seed=2)
    assert cache["groups"]["slot0"]["k"].shape[2] == 8   # a ring of 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) <= TOL, i
    full = model.prefill_fn(p, {"tokens": torch.from_numpy(toks)}).numpy()
    assert (got[-1].argmax(-1) == full.argmax(-1)).all()


def test_batched_positions_independent():
    """Two rows decoded together, row 1 starting 3 steps after row 0 (it
    idles at position 0 until then, as a server's empty slot does), each
    equal to its own solo decode."""
    cfg = get_arch("starcoder2-15b").reduced()
    model = build_model(cfg)
    p = lm_params_to_torch(shared_params(cfg, 7), device="cpu")
    s, lag = 12, 3
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    cache = model.init_cache(2, s, device="cpu")
    last = None
    for i in range(s + lag):
        t = np.zeros((2, 1), np.int32)
        pos = np.zeros(2, np.int32)
        if i < s:
            t[0, 0], pos[0] = toks[0, i], i
        if i >= lag:
            t[1, 0], pos[1] = toks[1, i - lag], i - lag
        out = model.serve_step(p, cache, torch.from_numpy(t),
                               torch.from_numpy(pos)).numpy()
        if i == s - 1:
            last = out[0]
    row1 = out[1]

    def solo(row):
        c = model.init_cache(1, s, device="cpu")
        for i in range(s):
            o = model.serve_step(p, c, torch.from_numpy(toks[row:row + 1,
                                                             i:i + 1]),
                                 torch.full((1,), i, dtype=torch.int32))
        return o.numpy()[0]

    np.testing.assert_allclose(last, solo(0), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(row1, solo(1), rtol=2e-4, atol=2e-4)


BF16_TOL = 5e-2     # the repo's bf16 tolerance
PREFIXES = (5, 13, 24)


@pytest.mark.parametrize("name", ["gemma3-4b", "starcoder2-15b"])
def test_bf16_decode_against_prefill_gap_is_the_references(name):
    """A reduced config cast to bf16 in both packages, from the same
    (bf16-rounded) parameters and tokens, 24 steps (gemma3-4b's ring of 8
    wraps): the port's decode-vs-prefill gap (normalized logits, every
    step of ``PREFIXES`` against the prefill of its prefix, one JAX
    compile each) is no larger than the JAX
    package's, and the port's logits, decode and prefill, lie within the
    bf16 tolerance of the JAX package's."""
    import dataclasses

    bf = dict(param_dtype="bfloat16", act_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(name).reduced(), **bf)
    model = build_model(cfg)
    jmodel = jbuild_model(dataclasses.replace(JARCHS[name].reduced(), **bf))
    p = tree_map(lambda t: t.to(torch.bfloat16), lm_params_to_torch(
        shared_params(get_arch(name).reduced(), 0), device="cpu"))
    jp = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), p)
    b, s = 2, 24
    toks = np.random.default_rng(100).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    cache, jcache = model.init_cache(b, s, device="cpu"), \
        jmodel.init_cache(b, s)
    step, prefill = jax.jit(jmodel.serve_step), jax.jit(jmodel.prefill_fn)
    gap, jgap = 0.0, 0.0
    for i in range(s):
        pos = np.full((b,), i, np.int32)
        d = model.serve_step(p, cache, torch.from_numpy(toks[:, i:i + 1]),
                             torch.from_numpy(pos)).float().numpy()
        jd, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                          jnp.asarray(pos))
        jd = np.asarray(jd, np.float32)
        assert rel(d, jd) <= BF16_TOL, (name, i)
        if i + 1 not in PREFIXES:
            continue
        f = model.prefill_fn(p, {"tokens": torch.from_numpy(
            toks[:, :i + 1])}).float().numpy()
        jf = np.asarray(prefill(jp, {"tokens": jnp.asarray(
            toks[:, :i + 1])}), np.float32)
        gap = max(gap, float(np.abs(normalized(d) - normalized(f)).max()))
        jgap = max(jgap, float(np.abs(normalized(jd)
                                      - normalized(jf)).max()))
        assert rel(f, jf) <= BF16_TOL, (name, i)
    assert gap <= jgap + 1e-6, (gap, jgap)
