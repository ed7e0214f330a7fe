"""Deterministic synthetic LM data, as the JAX package's
``repro.data.pipeline``.

``SyntheticLMData.batch(step)`` is a pure function of (seed, step) and is
the JAX package's numpy code, so its batches equal that package's bit for
bit; hosts materialize disjoint row slices. A restart from a checkpoint
resumes the exact data order from the step alone, with no iterator state
persisted.

``make_batch_iterator`` prefetches on a background thread. On a CUDA
device the thread builds each batch in pinned host memory and copies it
to the card on a side stream, and records an event after the copy; the
consumer's ``next`` makes its current stream wait on that event (and
marks the tensors as used there), so a step never reads a batch whose
copy has not finished, and batch N+1 crosses while step N runs. On the
CPU the batch is handed over as numpy-backed tensors. With
``shardings`` (a step's ``sharding.BatchShardings``, the JAX package's
``device_put`` by ``batch_sh``) each data index's rows go from pinned
memory to its own slots' devices only (one side stream and one event per
card), as ``elastic.Placed`` leaves: under accumulation each data
index's part of every microbatch is already on its devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["SyntheticLMData", "make_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def _motifs(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 7)
        return rng.integers(0, self.vocab_size,
                            (self.n_motifs, self.motif_len))

    def batch(self, step: int, *, host_id: int = 0,
              host_count: int = 1) -> dict:
        """Batch for `step` as numpy int32 arrays; hosts materialize
        disjoint row slices."""
        if self.global_batch % host_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {host_count} hosts")
        rows = self.global_batch // host_count
        rng = self._rng(step * host_count + host_id)
        motifs = self._motifs()
        # Zipf-ish unigram floor
        ranks = np.arange(1, self.vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(self.vocab_size, size=(rows, self.seq_len + 1),
                          p=probs)
        # plant motifs: ~25% of positions covered by copyable patterns
        n_plant = max((self.seq_len // self.motif_len) // 4, 1)
        for r in range(rows):
            for _ in range(n_plant):
                m = motifs[rng.integers(0, self.n_motifs)]
                at = rng.integers(0, self.seq_len + 1 - self.motif_len)
                toks[r, at: at + self.motif_len] = m
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class BatchIterator:
    """Batches from a prefetch thread (see the module docstring);
    ``close`` stops and joins the thread. A batch the thread failed to
    build re-raises its error in ``next``."""

    def __init__(self, source: SyntheticLMData, start_step: int,
                 prefetch: int, host_id: int, host_count: int, device,
                 shardings=None):
        self.device = torch.device(device)
        self.shardings = shardings
        devices = ([self.device] if shardings is None
                   else shardings.mesh.distinct_devices())
        self.cards = [d for d in devices if d.type == "cuda"]
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._args = (source, start_step, host_id, host_count)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _build(self, source, step, host_id, host_count, streams):
        b = source.batch(step, host_id=host_id, host_count=host_count)
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if self.shardings is not None and not streams:
            return self.shardings.place(b), []
        if not streams:
            return b, []
        with contextlib.ExitStack() as stack:
            for s in streams:
                stack.enter_context(torch.cuda.stream(s))
            if self.shardings is not None:
                # each copy on its card's current stream: the side stream
                b = self.shardings.place(b, pin=True)
            else:
                b = {k: v.pin_memory().to(self.device, non_blocking=True)
                     for k, v in b.items()}
        done = []
        for s in streams:
            ev = torch.cuda.Event()
            ev.record(s)
            done.append((s.device, ev))
        return b, done

    def _work(self):
        source, step, host_id, host_count = self._args
        streams = [torch.cuda.Stream(d) for d in self.cards]
        while not self._stop.is_set():
            try:
                item = self._build(source, step, host_id, host_count,
                                   streams)
            except Exception as exc:  # noqa: BLE001 — re-raised by next
                item = exc
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, done = item
        for dev, ev in done:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ev)
            for t in _tensors(batch):
                if t.device == dev:
                    t.record_stream(consumer)
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)


def _tensors(batch) -> list:
    """The tensors of a batch (a Placed leaf's blocks included)."""
    out = []
    for v in batch.values():
        out.extend(v if isinstance(v, list) else [v])
    return out


def make_batch_iterator(source: SyntheticLMData, *, start_step: int = 0,
                        prefetch: int = 2, host_id: int = 0,
                        host_count: int = 1, device="cuda",
                        shardings=None) -> Iterator[dict]:
    """Double-buffered iterator of ``source``'s batches from
    ``start_step`` on, as tensors on `device`, or placed by `shardings`
    (a ``sharding.BatchShardings``: each data index's rows on its slots'
    devices, `device` unused): batch N+1 is built (and copied) while the
    model runs step N. Restart-safe: pass the checkpointed step as
    `start_step` and the stream resumes exactly."""
    return BatchIterator(source, start_step, prefetch, host_id, host_count,
                         device, shardings)
