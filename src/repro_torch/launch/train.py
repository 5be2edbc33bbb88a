"""Production training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 4 --seq-len 4096 --global-batch 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --device cpu --steps 50 --ckpt-dir /tmp/ckpt

Selects an architecture config (``--smoke`` for the reduced variant),
builds the DVV control plane (store + checkpoint manager), restores if a
manifest exists, trains, and checkpoints on the configured cadence.  The
model, its optimizer state and the store's batched planes run on
``--device`` (default ``cuda``, which needs a card): attention's forward
and backward run through the hand-written CUDA kernels there, and through
their plain torch versions on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..ckpt import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..core import DVV_MECHANISM
from ..data import PipelineConfig
from ..optim import AdamWConfig
from ..runtime.train_loop import Trainer, TrainerConfig
from ..store import KVCluster, SimNetwork


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the arch family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--run-id", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault-injection: raise after this step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    elif args.device == "cpu" and cfg.param_count() > 1e9:
        print(f"WARNING: {cfg.name} has {cfg.param_count()/1e9:.1f}B params "
              f"to train on the CPU; use --smoke (or --device cuda).",
              file=sys.stderr)

    blob = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
    os.makedirs(blob, exist_ok=True)
    store = KVCluster(("cp1", "cp2", "cp3"), DVV_MECHANISM,
                      network=SimNetwork(seed=args.seed), device=args.device)
    run_id = args.run_id or f"{cfg.name}-train"
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        PipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                       global_batch=args.global_batch, seed=args.seed),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      log_every=max(args.steps // 20, 1), seed=args.seed),
        CheckpointManager(store, blob, run_id, "cp1"), device=args.device)

    if trainer.try_restore():
        print(f"restored from step {trainer.step} (run {run_id})")
    else:
        trainer.init_fresh()
        print(f"fresh run {run_id}: {cfg.name}, "
              f"{cfg.param_count()/1e6:.1f}M params on {trainer.device}")
    stats = trainer.run(crash_at=args.crash_at)
    trainer.save()
    for row in trainer.metrics_log:
        print(f"  step {row['step']:>6d}  loss {row['loss']:.4f}  "
              f"gnorm {row['grad_norm']:.3f}")
    print(f"done: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
