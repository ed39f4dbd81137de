"""Training launcher CLI: the port of ``repro.launch.train``.

A single-process ``repro_torch.training.Trainer`` on the CUDA card (``--device
cpu`` for the CPU) with checkpoint and resume. It prints the reference's
``[train]`` lines, and one per logged step (``--log-every``). ``--tiny``
swaps in the reduced config the CPU tests use; on the card it runs in
bfloat16, the dtype the port's flash-attention kernel takes (the reduced
configs are float32 for the CPU). ``--superblocks N`` keeps the first N
superblocks at full width, as ``launch/serve.py`` does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_1b --tiny \\
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b --tiny \\
      --steps 50 --ckpt-dir "$TMPDIR/run1"
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b --tiny --resume \\
      --steps 100 --ckpt-dir "$TMPDIR/run1"      # continues from the checkpoint
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_1b --steps 30 \\
      --batch 2 --seq-len 4096 --warmup 5 --log-every 1   # full width on the card
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.training.train_loop import TrainConfig, Trainer

__all__ = ["run", "main"]


def run(argv=None):
    """Parse ``argv``, train, print the ``[train]`` lines; returns (the
    trainer, with its ``metrics_log`` and ``straggler_events``, the trained
    model, the optimizer state)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--tiny", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=TrainConfig.warmup,
                    help="linear warmup steps of the cosine schedule")
    ap.add_argument("--log-every", type=int, default=TrainConfig.log_every)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--superblocks", type=int, default=None,
                    help="train only the first N superblocks (a depth cut; widths unchanged)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    device = resolve_device(args.device)
    if args.tiny:
        cfg = cfg.reduced()
        if device.type == "cuda":
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
    n_sb = cfg.num_superblocks
    if args.superblocks is not None:
        if not 1 <= args.superblocks <= n_sb:
            ap.error(f"--superblocks {args.superblocks} outside 1..{n_sb} for {cfg.name}")
        cfg = dataclasses.replace(cfg, num_superblocks=args.superblocks)
    tc = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                     checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
                     log_every=args.log_every, lr=args.lr, warmup=args.warmup, seed=args.seed)
    trainer = Trainer(cfg, tc, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[train] {cfg.name} ({cfg.dtype}, remat {cfg.remat}; superblocks: "
          f"{cfg.num_superblocks} of {n_sb}) on {name}: {args.steps} steps of "
          f"{args.batch} x {args.seq_len}")
    if args.resume:
        model, state, step = trainer.resume()
        print(f"[train] resumed {args.arch} at step {step}")
        model, state, _ = trainer.run(model, state, start_step=step)
    else:
        model, state, _ = trainer.run()
    for rec in trainer.metrics_log:
        print(f"[train] step {rec['step']} loss {rec['loss']:.4f} "
              f"({rec['step_time_s'] * 1e3:.1f} ms)")
    last = trainer.metrics_log[-1]
    print(f"[train] done: step {last['step']} loss {last['loss']:.4f}")
    return trainer, model, state


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
