"""End-to-end training driver with failure injection.

Trains a ~20M-parameter granite-family model for a few hundred steps on
CPU, checkpointing through the DVV-replicated control plane; at one third
of the run the process "crashes" and training resumes from the replicated
manifest — final state is bitwise identical to an uninterrupted run (the
assertion at the bottom).

The PyTorch port of ``examples/train_e2e.py``: the same runs, lines and
bitwise-resume assertion, training on ``--device`` (head_dim d_model / 8:
32 at the default width, through the flash-attention kernels on a card).
The parameters come from a ``torch.Generator``, so the losses and
fingerprints differ from the JAX package's.

Run:  PYTHONPATH=src python examples_torch/train_e2e.py [--steps 300]
      [--d-model 256] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import DVV_MECHANISM
from repro_torch.data import PipelineConfig
from repro_torch.models import LayerSpec, ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.store import KVCluster, SimNetwork


def model_cfg(d_model: int) -> ModelConfig:
    # granite-8b family, laptop-scale: ~20M params at d_model=256
    return ModelConfig(
        name="granite-mini", family="dense", n_layers=4, d_model=d_model,
        n_heads=8, n_kv_heads=2, head_dim=d_model // 8, d_ff=4 * d_model,
        vocab_size=8192, pattern=(LayerSpec("attn", "mlp"),),
        tie_embeddings=True, remat=False)


def make_trainer(cfg, store, blob, node, steps, device):
    return Trainer(
        cfg,
        AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps),
        PipelineConfig(vocab_size=cfg.vocab_size, seq_len=128,
                       global_batch=8, seed=7),
        TrainerConfig(total_steps=steps, ckpt_every=max(steps // 6, 10),
                      log_every=max(steps // 15, 5)),
        CheckpointManager(store, blob, run_id="e2e", node_id=node),
        device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = model_cfg(args.d_model)
    print(f"model: {cfg.name}, {cfg.param_count()/1e6:.1f}M params")

    # reference run (uninterrupted)
    store_ref = KVCluster(("s1", "s2", "s3"), DVV_MECHANISM,
                          network=SimNetwork(seed=0), device=args.device)
    ref = make_trainer(cfg, store_ref, tempfile.mkdtemp(), "s1", args.steps,
                       args.device)
    ref.init_fresh()
    print("reference run...")
    ref.run()
    for row in ref.metrics_log[:3] + ref.metrics_log[-3:]:
        print("  ", row)

    # faulty run: crash at 1/3, resume on a different control-plane node
    store = KVCluster(("s1", "s2", "s3"), DVV_MECHANISM,
                      network=SimNetwork(seed=0), device=args.device)
    blob = tempfile.mkdtemp()
    t1 = make_trainer(cfg, store, blob, "s1", args.steps, args.device)
    t1.init_fresh()
    crash_at = args.steps // 3
    print(f"\nfaulty run: will crash at step {crash_at}...")
    try:
        t1.run(crash_at=crash_at)
    except RuntimeError as e:
        print(f"  {e}")
    store.antientropy_round()   # control plane converges

    t2 = make_trainer(cfg, store, blob, "s2", args.steps, args.device)
    assert t2.try_restore(), "no manifest found after crash!"
    print(f"  resumed at step {t2.step} on node s2")
    t2.run()

    fp_ref, fp_resumed = ref.state_fingerprint(), t2.state_fingerprint()
    print(f"\nreference   final loss {ref.metrics_log[-1]['loss']:.4f}  "
          f"fingerprint {fp_ref}")
    print(f"crash+resume final loss {t2.metrics_log[-1]['loss']:.4f}  "
          f"fingerprint {fp_resumed}")
    assert fp_ref == fp_resumed, "resume was not bitwise identical!"
    print("\nPASS: crash/resume is bitwise identical to the uninterrupted run")


if __name__ == "__main__":
    main()
