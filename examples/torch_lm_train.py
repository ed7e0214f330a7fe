"""Train a small LM from the assigned-architecture zoo on the port: the
twin of examples/lm_train.py.

The whole training substrate runs: the deterministic pipeline prefetched
to the device, the train step (autograd with the model's checkpoints,
AdamW), async checkpoints and the fault supervisor, on a reduced config
(~0.1-0.5M parameters). Every one of the 10 assigned archs works.

Run:  PYTHONPATH=src python examples/torch_lm_train.py --arch gemma3-4b
      (add --device cpu to train on the CPU)
"""
import argparse

from repro_torch.configs import arch_names, get_arch
from repro_torch.launch.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-15b",
                    choices=arch_names())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch).reduced()
    res = train_loop(cfg, steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     log_every=10, device=args.device)
    first = res.losses[0] if res.losses else float("nan")
    print(f"\n{args.arch} (reduced, {args.device}): loss {first:.3f} -> "
          f"{res.final_loss:.3f} over {res.steps_done} steps")
    if not res.final_loss < first:
        raise SystemExit("loss should decrease")


if __name__ == "__main__":
    main()
