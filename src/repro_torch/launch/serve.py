"""Batched LM serving with a continuous request queue.

The JAX package's ``repro.launch.serve`` in PyTorch, with the same
semantics: fixed batch slots, each owning a sequence (prompt plus
generation state); finished slots are refilled from the queue; one
``serve_step`` decodes a token for every slot per iteration, and a new
request's prompt is ingested token by token through the same step.

On the card the step is ONE CUDA graph (``core/graphs.capture``),
captured once per server for its (batch_slots, s_max) over static
buffers: the tokens, the positions, the logits and the whole cache, which
``serve_step`` writes in place. A failed capture raises, naming the
architecture. On the CPU the step runs eagerly.

Run on the card (reduced config):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import graphs
from repro_torch.models import build_model
from repro_torch.models.tree import tree_leaves


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


class BatchedServer:
    """``params`` (a parameter tree on `device`) replaces the draw from
    ``seed``; the sampling generator is numpy's, seeded with ``seed`` as
    in the JAX package, so both servers draw the same tokens from the
    same logits."""

    def __init__(self, cfg, batch_slots: int = 4, s_max: int = 128,
                 seed: int = 0, temperature: float = 0.0, *,
                 device="cuda", params=None):
        self.cfg = cfg
        self.model = build_model(cfg)
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init_params(gen)
        self.params = params
        self.b = batch_slots
        self.s_max = s_max
        self.temperature = temperature
        self._rng = np.random.default_rng(seed)
        self.cache = self.model.init_cache(batch_slots, s_max,
                                           device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)
        self._slot_dirty = [False] * batch_slots  # slot held a request before
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pending: List[list] = [[] for _ in range(batch_slots)]
        self._tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._positions = torch.zeros((batch_slots,), dtype=torch.int32,
                                      device=self.device)
        self._step = self._capture()
        # prefill and decode are separate throughput regimes: prefill tokens
        # re-ingest the prompt, only decode tokens are generated output
        self.prefill_tokens = 0
        self.decode_tokens = 0

    def _capture(self):
        def step(tokens, positions):
            return self.model.serve_step(self.params, self.cache, tokens,
                                         positions)

        try:
            replay = graphs.capture(step, self._tokens, self._positions,
                                    device=self.device)
        except RuntimeError as e:
            raise RuntimeError(
                f"{self.cfg.name}: capturing the decode step as a CUDA graph "
                f"failed: {e}") from e
        # the capture's eager warm-up wrote into the cache: start clean
        for leaf in tree_leaves(self.cache):
            leaf.zero_()
        return replay

    def decode(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """One ``serve_step`` for every slot: tokens (B, 1) and positions
        (B,) are copied into the step's buffers; on the card the captured
        graph replays. Returns the (B, vocab) float32 logits, on the card
        in the graph's output buffer (overwritten by the next step)."""
        return self._step(tokens, positions)

    @property
    def tokens_served(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    def _next_token(self, logits_i: np.ndarray) -> int:
        """Greedy at temperature 0, softmax sampling above."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits_i))
        z = logits_i.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(p.size, p=p))

    # attention caches are position-indexed: `attention_decode`/`mla_decode`
    # mask cache slot j invisible until the new request's own write at
    # position j (or its ring image) has overwritten it, so stale rows are
    # unreachable and need no clearing. Everything else (mamba/mlstm/slstm
    # recurrent state) has no positions and WOULD leak the finished
    # request's state forward.
    _POS_MASKED_KEYS = ({"k", "v"}, {"ckv", "kpe"})

    def _clear_slot(self, i: int):
        """Zero slot i's rows in every non-position-masked cache leaf
        before reuse (see _POS_MASKED_KEYS), in place. head/tail slot
        caches carry batch at axis 0, the grouped caches at axis 1
        (n_groups leads)."""

        def clear(c, batch_axis=0):
            if isinstance(c, dict) and set(c) in self._POS_MASKED_KEYS:
                return  # attention KV: stale rows proven unreachable
            idx = (slice(None),) * batch_axis + (i,)
            for leaf in tree_leaves(c):
                leaf[idx].zero_()

        for key in ("head", "tail"):
            for c in self.cache.get(key, ()):
                clear(c)
        for c in self.cache.get("groups", {}).values():
            clear(c, batch_axis=1)

    def _admit(self, queue: list):
        for i in range(self.b):
            while self.slot_req[i] is None and queue:
                req = queue.pop(0)
                if len(req.prompt) >= self.s_max:
                    # the prompt alone fills the KV cache: prefill would
                    # never finish and pos would run past the cache bounds
                    req.error = (f"prompt length {len(req.prompt)} >= "
                                 f"cache size s_max={self.s_max}")
                    req.done = True
                    continue
                if self._slot_dirty[i]:
                    self._clear_slot(i)
                self.slot_req[i] = req
                self.slot_pending[i] = list(req.prompt)
                self.pos[i] = 0
                self._slot_dirty[i] = True

    def step(self, queue: list):
        """One decode iteration across all slots."""
        self._admit(queue)
        tok = np.zeros((self.b, 1), np.int32)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.slot_pending[i]:
                tok[i, 0] = self.slot_pending[i].pop(0)  # prefill token
            else:
                tok[i, 0] = req.out[-1]                  # autoregressive
        logits = self.decode(torch.from_numpy(tok),
                             torch.from_numpy(self.pos)).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.pos[i] += 1
            if self.slot_pending[i]:  # still ingesting the prompt
                self.prefill_tokens += 1
                continue
            self.decode_tokens += 1
            req.out.append(self._next_token(logits[i]))
            if len(req.out) >= req.max_new or \
                    self.pos[i] >= self.s_max - 1:
                req.done = True
                self.slot_req[i] = None

    def run(self, requests: list, max_iters: int = 10_000):
        queue = list(requests)
        it = 0
        while (queue or any(self.slot_req)) and it < max_iters:
            self.step(queue)
            it += 1
        return requests


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-15b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_arch(args.arch).reduced()
    server = BatchedServer(cfg, temperature=args.temperature,
                           device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=8),
                    max_new=args.max_new) for _ in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    if not all(r.done for r in reqs):
        raise SystemExit("not every request was served")
    print(f"served {len(reqs)} requests in {dt:.1f}s on {args.device}: "
          f"{server.decode_tokens} decode tokens "
          f"({server.decode_tokens / dt:.1f} decode tok/s), "
          f"{server.prefill_tokens} prefill tokens "
          f"({server.tokens_served / dt:.1f} total tok/s)")


if __name__ == "__main__":
    main()
