"""Quickstart: the three layers of the framework in 60 lines.

  1. DVV clocks (the paper's contribution) on a replicated KV store;
  2. a model from the zoo doing a forward/train step;
  3. a DVV-checkpointed training step you can kill and resume.

The PyTorch port of ``examples/quickstart.py``: the same steps and lines,
with the store's batched planes, the model (gemma-2b's smoke config,
head_dim 16, through the flash-attention kernel on a card) and the
training on ``--device``.  The parameters come from a ``torch.Generator``,
so the numbers differ from the JAX package's.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import DVV_MECHANISM
from repro_torch.data import PipelineConfig
from repro_torch.models import forward, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.store import KVClient, KVCluster, SimNetwork


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    # --- 1. the paper: concurrent writes through ONE coordinator survive ---
    store = KVCluster(("a", "b"), DVV_MECHANISM, network=SimNetwork(seed=0),
                      device=dev)
    c1 = KVClient(store, "c1", via="b")
    c2 = KVClient(store, "c2", via="b")
    c1.put("config", "v-from-client1")
    c2.put("config", "v-from-client2")
    got = c1.get("config")
    print(f"siblings after same-coordinator concurrent puts: {got.values}")
    assert set(got.values) == {"v-from-client1", "v-from-client2"}

    # the client resolves with the opaque causal token — the resolution
    # supersedes both siblings (see examples_torch/shopping_cart.py for the
    # full session walkthrough: token bytes, batched put_many, ...)
    c1.put("config", "merged", context=got.context)
    print(f"after context write: {c1.get('config').values}")

    # --- 2. a model from the zoo -------------------------------------------
    cfg = get_config("gemma-2b").smoke()      # reduced config, head_dim 16
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32, device=dev),
             "labels": torch.zeros((2, 16), dtype=torch.int32, device=dev)}
    with torch.no_grad():
        logits, _ = forward(params, batch, cfg)
    print(f"{cfg.name}: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")

    # --- 3. checkpointed training with crash recovery ----------------------
    def trainer(node_id):
        return Trainer(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
            PipelineConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4),
            TrainerConfig(total_steps=20, ckpt_every=5, log_every=5),
            CheckpointManager(store, blob, run_id="quickstart",
                              node_id=node_id),
            device=dev)

    blob = tempfile.mkdtemp()
    first = trainer("a")
    first.init_fresh()
    try:
        first.run(crash_at=12)                # dies after step 12
    except RuntimeError as e:
        print(f"crash injected: {e}")

    store.deliver_replication()  # control plane converges to node "b"
    resumed = trainer("b")
    assert resumed.try_restore()
    print(f"resumed from step {resumed.step} (checkpointed via the DVV "
          f"store)")
    stats = resumed.run()
    print(f"finished: {stats}")


if __name__ == "__main__":
    main()
