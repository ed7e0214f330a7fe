"""Batched serving demo on the port: continuous batching over 4 decode
slots, the decode step one CUDA graph on the card.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma3-4b
      (add --device cpu to run the step eagerly on the CPU)
"""
import argparse
import time

import numpy as np

from repro_torch.configs import arch_names, get_arch
from repro_torch.launch.serve import BatchedServer, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-15b",
                    choices=arch_names())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch).reduced()
    server = BatchedServer(cfg, batch_slots=4, s_max=64, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=8),
                    max_new=args.max_new) for _ in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt={list(r.prompt[:4])}... -> {r.out}")
    print(f"\n{server.decode_tokens} decode + {server.prefill_tokens} "
          f"prefill tokens in {dt:.1f}s ({server.decode_tokens/dt:.1f} "
          f"decode tok/s, {args.arch} reduced, {args.device})")


if __name__ == "__main__":
    main()
