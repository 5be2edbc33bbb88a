"""Serving launcher: batched decode with DVV-replicated session state.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --requests 8 --tokens 16

Continuous-batching-lite, as in the JAX package: a fixed decode batch of
slots; finished requests release their slot and queued requests claim it
at the next step boundary.  All slots share one decode position ``pos``,
so a request admitted later decodes at the global position (the JAX
package's behaviour, kept).  Each finished request's tokens persist as
``session/<rid>`` in the port's replicated store, so another serving node
can adopt the session.

The model and the store run on ``--device`` (default ``cuda``, which needs
a card).  ``--store-workload`` drives the store's serving plane
(``store/serving.py``), which is not ported yet: it exits with code 2.
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
from ..store import KVCluster, SimNetwork
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random parameters")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store-workload", action="store_true",
                    help="the closed-loop store workload (not ported)")
    args = ap.parse_args(argv)

    if args.store_workload:
        print("--store-workload needs store/serving.py, which the port has "
              "not ported yet (ROADMAP Queue 1 item 4)", file=sys.stderr)
        return 2
    if args.arch is None:
        ap.error("--arch is required")

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
