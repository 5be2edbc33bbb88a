"""The training runtime: the train step + DVV-checkpointed state machine.

One ``Trainer`` is one logical training job.  Every ``ckpt_every`` steps it
persists (params, opt moments, data cursor, RNG fold) through the
CheckpointManager — whose manifests live in the replicated DVV store — so
a crash at ANY point resumes bitwise-identically, including after
divergent manifests from a partitioned control plane (the manager
reconciles deterministically).

The state's flattened names (``p/embed``, ``p/blocks/layer0/attn/wq``,
``o/m/...``, ``o/v/...``, ``o/step``), their dtypes and the order
``state_fingerprint`` hashes them in are the JAX package's, so a
checkpoint written by either package restores in the other.  The model,
the optimizer state and the step run on ``device`` (default ``"cuda"``,
which needs a card).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..data import PipelineConfig, SyntheticTokens
from ..launch.steps import make_train_step
from ..models import ModelConfig, init_params
from ..optim import AdamWConfig, init_opt_state
from ..optim.adamw import tree_leaves


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    mesh_shape: Tuple[int, ...] = (1,)


def _paths(prefix: str, tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) in ``jax.tree_util.tree_flatten_with_path`` order, each
    name the prefix and the dict keys joined by '/'."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _paths(f"{prefix}{k}/", tree[k])]
    return [(prefix[:-1], tree)]


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise ValueError("bf16 state leaves do not round-trip through the "
                         "shard codec (np.save writes them as void) in "
                         "either package")
    return t.detach().cpu().numpy()


def _flatten_state(params, opt_state) -> Dict[str, np.ndarray]:
    return {name: _host(leaf)
            for prefix, tree in (("p/", params), ("o/", opt_state))
            for name, leaf in _paths(prefix, tree)}


@torch.no_grad()
def _unflatten_state(arrays: Dict[str, np.ndarray], params, opt_state
                     ) -> None:
    """Copy the named arrays into the leaves of ``params`` and
    ``opt_state`` (their dtypes, shapes and device)."""
    for prefix, tree in (("p/", params), ("o/", opt_state)):
        for name, leaf in _paths(prefix, tree):
            leaf.copy_(torch.from_numpy(np.ascontiguousarray(arrays[name]))
                       .reshape(leaf.shape))


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 pipe_cfg: PipelineConfig, trainer_cfg: TrainerConfig,
                 ckpt: CheckpointManager, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to train on the CPU")
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.trainer_cfg = trainer_cfg
        self.ckpt = ckpt
        self.pipeline = SyntheticTokens(pipe_cfg)
        self.step = 0
        self.params = None
        self.opt_state = None
        self.metrics_log: List[Dict] = []
        self._train_step = make_train_step(model_cfg, opt_cfg)

    # -- lifecycle ------------------------------------------------------------
    def init_fresh(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(
            self.trainer_cfg.seed)
        self.params = init_params(gen, self.model_cfg, device=self.device)
        self.opt_state = init_opt_state(self.params, self.opt_cfg)
        self.step = 0
        self.pipeline.restore(0)

    def try_restore(self) -> bool:
        """Restore from the latest manifest; returns True if one existed."""
        if self.params is None:
            self.init_fresh()           # build templates for unflatten
        res = self.ckpt.restore()
        if res is None:
            return False
        _unflatten_state(res.arrays, self.params, self.opt_state)
        self.step = res.manifest.step
        self.pipeline.restore(res.manifest.data_cursor)
        return True

    def save(self) -> None:
        arrays = _flatten_state(self.params, self.opt_state)
        self.ckpt.save(
            self.step, arrays, data_cursor=self.pipeline.state(),
            rng_seed=self.trainer_cfg.seed, rng_fold=self.step,
            mesh_shape=self.trainer_cfg.mesh_shape)

    # -- run -----------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            crash_at: Optional[int] = None) -> Dict:
        """Train ``steps`` (default: to total_steps).  ``crash_at`` raises
        mid-run AFTER that step — the fault-injection hook used by tests
        and the e2e example."""
        target = min(self.trainer_cfg.total_steps,
                     self.step + (steps or self.trainer_cfg.total_steps))
        t0 = time.time()
        while self.step < target:
            batch_np = self.pipeline.next_batch()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.trainer_cfg.log_every == 0 or \
                    self.step == target:
                row = {"step": self.step,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"])}
                self.metrics_log.append(row)
            if self.step % self.trainer_cfg.ckpt_every == 0:
                self.save()
            if crash_at is not None and self.step >= crash_at:
                raise RuntimeError(f"injected crash at step {self.step}")
        return {"steps": self.step, "wall_s": time.time() - t0,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None}

    def state_fingerprint(self) -> str:
        """Hash of all params — for bitwise resume assertions."""
        h = hashlib.sha256()
        for leaf in tree_leaves(self.params):
            t = leaf.detach()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)     # the same bytes as JAX's bf16
            h.update(t.cpu().numpy().tobytes())
        h.update(str(self.pipeline.state()).encode())
        return h.hexdigest()[:16]
