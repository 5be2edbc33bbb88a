"""Serving launcher: batched decode with DVV-replicated session state.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --requests 8 --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --store-workload

Continuous-batching-lite, as in the JAX package: a fixed decode batch of
slots; finished requests release their slot and queued requests claim it
at the next step boundary.  All slots share one decode position ``pos``,
so a request admitted later decodes at the global position (the JAX
package's behaviour, kept).  Each finished request's tokens persist as
``session/<rid>`` in the port's replicated store, so another serving node
can adopt the session.

The model and the store run on ``--device`` (default ``cuda``, which needs
a card).  ``--store-workload`` runs no model: it drives the store's
coalescing serving plane with the closed-loop engine (``store/serving.py``)
in each ``--store-mode`` and prints one JSON summary per mode, as the JAX
package's launcher does.  ``--seed`` seeds the model's parameters (default
0) or the store workload's draws (default 11).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..core import DVV_MECHANISM
from ..models import init_cache, init_params
from ..store import ClosedLoopEngine, GossipDriver, KVCluster, SimNetwork
from .steps import make_decode_step


@dataclass
class Request:
    rid: int
    prompt_token: int
    max_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_tokens


class BatchScheduler:
    """Slot-based continuous batching over one shared decode cache, on the
    device of ``params``."""

    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 store: KVCluster, node: str):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.store = store
        self.node = node
        self.device = params["final_norm"].device
        self.cache = init_cache(cfg, batch_slots, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.pos = 0
        self._step = make_decode_step(cfg)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, queue: List[Request]) -> None:
        for slot in self._free_slots():
            if not queue:
                break
            req = queue.pop(0)
            req.slot = slot
            self.slot_req[slot] = req

    def step(self) -> None:
        toks = torch.tensor(
            [r.generated[-1] if (r and r.generated) else
             (r.prompt_token if r else 0)
             for r in self.slot_req], dtype=torch.int32, device=self.device)
        logits, self.cache = self._step(self.params, self.cache, toks,
                                        self.pos)
        nxt = torch.argmax(logits, dim=-1).tolist()   # first maximal index
        self.pos += 1
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.generated.append(int(nxt[i]))
            if req.done:
                self._persist(req)
                self.slot_req[i] = None

    def _persist(self, req: Request) -> None:
        key = f"session/{req.rid}"
        res = self.store.get(key, via=self.node)
        self.store.put(key, json.dumps(
            {"tokens": req.generated, "pos": self.pos}),
            context=res.context, via=self.node, client_id=self.node)


def serve_requests(sched: BatchScheduler, queue: List[Request]) -> int:
    """Admit and decode until the queue is drained and every slot is free
    (or the cache is full); returns the number of decode steps."""
    steps = 0
    while (queue or any(sched.slot_req)) and steps < sched.max_len - 1:
        sched.admit(queue)
        sched.step()
        steps += 1
    return steps


def store_workload(mode: str, args: argparse.Namespace, *,
                   use_kernel: bool = True):
    """One mode of the store workload on a fresh cluster on ``args.device``
    (5 nodes, replication 3, R=W=2, packed DVV, read-repair on), with a
    ``GossipDriver`` when ``args.gossip_period`` > 0.  Returns ``(cluster,
    driver or None, engine)``; the engine has not run yet."""
    net = SimNetwork(seed=7, jitter=0.0)
    cluster = KVCluster(tuple(f"n{i}" for i in range(5)), DVV_MECHANISM,
                        replication=3, network=net, read_quorum=2,
                        write_quorum=2, seed=7, device=args.device)
    driver = None
    if args.gossip_period > 0:
        driver = GossipDriver(cluster, period=args.gossip_period, seed=7,
                              use_kernel=use_kernel)
        driver.start()              # timers interleave with the engine
    eng = ClosedLoopEngine(
        cluster, sessions=args.sessions, keys=args.keys,
        zipf_s=args.zipf, concurrency=args.concurrency,
        mode=mode, via="n0", seed=args.seed, read_repair=True,
        use_kernel=use_kernel, max_batch=args.max_batch,
        max_delay=args.max_delay)
    return cluster, driver, eng


def store_workload_main(args: argparse.Namespace) -> int:
    """Drive the coalescing serving plane with the closed-loop engine
    (no model in the loop); prints one JSON summary per mode."""
    modes = (("coalesced", "direct") if args.store_mode == "both"
             else (args.store_mode,))
    summaries = {}
    for mode in modes:
        _, driver, eng = store_workload(mode, args)
        out = eng.run(args.store_steps)
        if driver is not None:
            out["gossip"] = {"rounds": driver.rounds,
                             "wire_bytes": driver.wire_bytes()}
            driver.stop()
        summaries[mode] = out
        print(json.dumps(out, indent=1))
    if len(summaries) == 2:
        d, c = summaries["direct"], summaries["coalesced"]
        if c["plane_per_1k_ops"]:
            print(f"plane ratio direct/coalesced: "
                  f"{d['plane_per_1k_ops'] / c['plane_per_1k_ops']:.1f}x, "
                  f"bytes/op {c['bytes_per_op']:.1f} vs "
                  f"{d['bytes_per_op']:.1f}")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the random parameters (default 0) or, "
                         "with --store-workload, of the workload (default "
                         "11)")
    ap.add_argument("--device", default="cuda")
    g = ap.add_argument_group("store workload (no model in the loop)")
    g.add_argument("--store-workload", action="store_true",
                   help="run the closed-loop store workload engine")
    g.add_argument("--store-mode", default="both",
                   choices=["coalesced", "direct", "both"])
    g.add_argument("--sessions", type=int, default=1_000_000)
    g.add_argument("--keys", type=int, default=10_000)
    g.add_argument("--zipf", type=float, default=0.9)
    g.add_argument("--concurrency", type=int, default=256)
    g.add_argument("--store-steps", type=int, default=500)
    g.add_argument("--max-batch", type=int, default=256)
    g.add_argument("--max-delay", type=float, default=2.0)
    g.add_argument("--gossip-period", type=float, default=0.0,
                   help="anti-entropy period in sim ticks (0 = off)")
    args = ap.parse_args(argv)
    if args.seed is None:
        args.seed = 11 if args.store_workload else 0
    if not args.store_workload and args.arch is None:
        ap.error("--arch is required unless --store-workload is given")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.store_workload:
        return store_workload_main(args)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if not cfg.is_decoder:
        print(f"{cfg.name} is encoder-only; nothing to decode",
              file=sys.stderr)
        return 2
    if cfg.input_mode != "tokens":
        print(f"{cfg.name} needs a modality frontend; nothing to serve "
              f"from tokens", file=sys.stderr)
        return 2

    device = torch.device(args.device)
    store = KVCluster(("srv1", "srv2"), DVV_MECHANISM,
                      network=SimNetwork(seed=0), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen, cfg, device=device)
    sched = BatchScheduler(cfg, params, args.batch_slots, args.max_len,
                           store, "srv1")
    queue = [Request(rid=i, prompt_token=i % cfg.vocab_size,
                     max_tokens=args.tokens)
             for i in range(args.requests)]
    t = time.perf_counter()
    steps = serve_requests(sched, queue)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t
    print(f"served {args.requests} requests in {steps} decode steps "
          f"({args.batch_slots} slots, continuous batching) on {device}: "
          f"{secs / max(steps, 1):.4f} s per step, "
          f"{args.requests * args.tokens / secs:.1f} tokens/s")
    for i in range(args.requests):
        res = store.get(f"session/{i}", via="srv1")
        toks = json.loads(res.values[0])["tokens"] if res.values else []
        print(f"  r{i}: {len(toks)} tokens {toks[:6]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
