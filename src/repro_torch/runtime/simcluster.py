"""Simulated multi-worker training cluster — where ALL the control-plane
pieces meet: DVV store, membership, heartbeats/failure detection, elastic
mesh replanning, and checkpoint-based recovery.

One process simulates N logical workers in lockstep rounds.  Each round:
workers heartbeat, the failure detector classifies them, the elastic
controller replans the mesh if membership changed, and the *leader*
(lowest-id live worker) advances training and checkpoints.  Failure events
(kill / stall / partition) are injected by the driver or tests.

The data plane executes once per round on the real device — the point of
the simulation is the control-plane state machine, which is exactly the
substrate the paper provides.  The store and the trainer run on
``device`` (default ``"cuda"``, which needs a card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..ckpt import CheckpointManager
from ..cluster import (
    Assignment, ElasticController, FailureDetector, MembershipService,
    NodeStatus,
)
from ..core import DVV_MECHANISM
from ..data import PipelineConfig
from ..optim import AdamWConfig
from ..store import KVCluster, SimNetwork
from .train_loop import Trainer, TrainerConfig


@dataclass
class SimWorker:
    worker_id: str
    alive: bool = True
    stalled: bool = False


class SimCluster:
    def __init__(self, *, n_workers: int, model_cfg, opt_cfg: AdamWConfig,
                 pipe_cfg: PipelineConfig, trainer_cfg: TrainerConfig,
                 blob_root: str, store_nodes: Tuple[str, ...] = ("s1", "s2", "s3"),
                 mesh_candidates=None, seed: int = 0, device="cuda"):
        self.store = KVCluster(store_nodes, DVV_MECHANISM,
                               network=SimNetwork(seed=seed), device=device)
        self.workers = {f"w{i}": SimWorker(f"w{i}") for i in range(n_workers)}
        self.membership = MembershipService(self.store, store_nodes[0])
        for w in self.workers:
            self.membership.join(w)
        self.fd = FailureDetector(heartbeat_interval=1.0)
        self.elastic = ElasticController(mesh_candidates or [
            ((n_workers,), ("data",)),
            ((max(n_workers // 2, 1),), ("data",)),
            ((1,), ("data",)),
        ])
        self.assignment: Optional[Assignment] = self.elastic.plan(
            self.membership.view())
        self.trainer = Trainer(
            model_cfg, opt_cfg, pipe_cfg, trainer_cfg,
            CheckpointManager(self.store, blob_root, "simrun",
                              store_nodes[0]), device=device)
        self.trainer.init_fresh()
        self.now = 0.0
        self.events: List[str] = []
        self.rescales = 0

    # -- fault injection -------------------------------------------------------
    def kill(self, worker_id: str) -> None:
        self.workers[worker_id].alive = False
        self.events.append(f"t={self.now:.0f} KILL {worker_id}")

    def stall(self, worker_id: str) -> None:
        self.workers[worker_id].stalled = True
        self.events.append(f"t={self.now:.0f} STALL {worker_id}")

    def recover(self, worker_id: str) -> None:
        w = self.workers[worker_id]
        w.alive, w.stalled = True, False
        self.membership.join(worker_id)
        self.events.append(f"t={self.now:.0f} RECOVER {worker_id}")

    # -- one control-plane round -------------------------------------------------
    def round(self, train_steps: int = 1) -> Dict:
        self.now += 1.0
        for w in self.workers.values():
            if w.alive and not w.stalled:
                self.fd.record(w.worker_id, self.now)
        # the leader marks detected-dead workers in the membership store
        for dead in self.fd.dead(self.now):
            view = self.membership.view()
            if dead in view.alive():
                self.membership.mark_dead(dead)
                self.events.append(f"t={self.now:.0f} DETECT-DEAD {dead}")
        view = self.membership.view()
        new_assign, changed = self.elastic.replan_on_failure(
            view, self.assignment)
        if changed and new_assign is not None:
            # rescale: restore-from-checkpoint then continue on the new mesh
            self.rescales += 1
            self.events.append(
                f"t={self.now:.0f} RESCALE {self.assignment and self.assignment.mesh_shape} "
                f"-> {new_assign.mesh_shape}")
            self.assignment = new_assign
            restored = self.trainer.try_restore()
            self.events.append(
                f"t={self.now:.0f} RESTORE step={self.trainer.step} "
                f"(found={restored})")
        # the data plane advances (leader-driven; single real device)
        if self.assignment is not None and \
                self.trainer.step < self.trainer.trainer_cfg.total_steps:
            self.trainer.run(steps=train_steps)
        self.store.deliver_replication()
        return {"step": self.trainer.step,
                "live": len(self.fd.alive(self.now)),
                "mesh": self.assignment.mesh_shape
                if self.assignment else None}
