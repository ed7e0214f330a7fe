"""The port's batched LM server (``repro_torch.launch.serve``) held to the
JAX package's ``BatchedServer`` on the CPU.

* On reduced starcoder2-15b, with the JAX server's own parameters
  (``init_params(PRNGKey(seed))``) carried across by
  ``lm_params_to_torch``, both servers emit the same tokens for more
  requests than slots: greedy, and at temperature 1.5 from the same seed
  (both sample with numpy's generator seeded alike).
* A prompt >= s_max is rejected at admission, not hung.
* Reusing a slot zeroes its recurrent state (xlstm) and leaves its KV
  rows in place, masked (starcoder2); either way the reused slot decodes
  what a fresh server does.
* The prefill/decode token accounting.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models.tree import tree_leaves

# the test workers share the machine's cores: one intra-op thread each
# keeps torch's OpenMP pool from spinning against the other workers
torch.set_num_threads(1)

ARCH = "starcoder2-15b"


def requests(cls, cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(2, 9))),
                max_new=6) for _ in range(n)]


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (1.5, 3)],
                         ids=["greedy", "t1.5"])
def test_same_tokens_as_the_jax_server(temperature, seed):
    jcfg = jget_arch(ARCH).reduced()
    jsrv = jserve.BatchedServer(jcfg, batch_slots=2, s_max=32, seed=seed,
                                temperature=temperature)
    params = lm_params_to_torch(jax.tree.map(np.asarray, jsrv.params),
                                device="cpu")
    srv = BatchedServer(get_arch(ARCH).reduced(), batch_slots=2, s_max=32,
                        seed=seed, temperature=temperature, device="cpu",
                        params=params)
    want = jsrv.run(requests(jserve.Request, jcfg))
    got = srv.run(requests(Request, jcfg))
    assert all(r.done and r.error is None for r in got)
    assert all(len(r.out) == 6 for r in got)
    assert all(0 <= t < jcfg.vocab_size for r in got for t in r.out)
    assert [r.out for r in got] == [r.out for r in want]
    assert (srv.prefill_tokens, srv.decode_tokens) == \
        (jsrv.prefill_tokens, jsrv.decode_tokens)


def test_long_prompt_rejected_not_hung():
    cfg = get_arch(ARCH).reduced()
    s_max = 16
    srv = BatchedServer(cfg, batch_slots=2, s_max=s_max, seed=0,
                        device="cpu")
    rng = np.random.default_rng(2)
    long1 = Request(prompt=rng.integers(0, cfg.vocab_size, s_max),
                    max_new=4)
    long2 = Request(prompt=rng.integers(0, cfg.vocab_size, s_max + 7),
                    max_new=4)
    ok = Request(prompt=rng.integers(0, cfg.vocab_size, 4), max_new=4)
    srv.run([long1, ok, long2], max_iters=200)
    assert long1.done and long1.error and long1.out == []
    assert long2.done and long2.error and long2.out == []
    assert ok.done and ok.error is None and len(ok.out) == 4
    assert (srv.pos < s_max).all()


@pytest.mark.parametrize("name", ["xlstm-1.3b", ARCH])
def test_slot_reuse_clears_recurrent_state(name):
    """One slot, two requests: the second reuses the first's slot and
    must decode what a fresh server decodes. Recurrent state is zeroed at
    admission; attention KV rows are left in place (masked until
    overwritten)."""
    cfg = get_arch(name).reduced()
    srv = BatchedServer(cfg, batch_slots=1, s_max=32, seed=7, device="cpu")
    a = Request(prompt=np.arange(3, 10), max_new=5)
    b = Request(prompt=np.arange(11, 16), max_new=5)
    srv.run([a])
    before = [t.clone() for t in tree_leaves(srv.cache)]
    assert any(torch.count_nonzero(t) for t in before)
    srv._admit([b])                       # into a's slot
    after = tree_leaves(srv.cache)
    if name == ARCH:      # attention KV only: left in place, masked
        assert all(torch.equal(x, y) for x, y in zip(before, after))
    else:                 # mLSTM/sLSTM state only: zeroed
        assert not any(torch.count_nonzero(t) for t in after)
    srv.run([])                           # decode b to its end
    fresh = BatchedServer(cfg, batch_slots=1, s_max=32, seed=7, device="cpu")
    b_fresh = Request(prompt=np.arange(11, 16), max_new=5)
    fresh.run([b_fresh])
    assert b.out == b_fresh.out, name


def test_prefill_decode_token_accounting():
    cfg = get_arch(ARCH).reduced()
    srv = BatchedServer(cfg, batch_slots=1, s_max=32, seed=0, device="cpu")
    reqs = [Request(prompt=np.arange(1, 5), max_new=6)]
    srv.run(reqs)
    # the step that ingests the last prompt token emits the first decode
    # token, so prefill counts len(prompt) - 1 steps
    assert srv.decode_tokens == 6
    assert srv.prefill_tokens == 3
    assert srv.tokens_served == srv.prefill_tokens + srv.decode_tokens
