"""The decode driver: the port's ``BatchScheduler`` (``launch/serve.py``:
slots over one shared cache, ``make_decode_step`` -> ``lm.decode_step``)
under a saturated closed loop, every finished request writing its
session to the port's ``KVCluster`` (a quorum GET, then a PUT with the
GET's causal context).

The mix fixes the slots, ``max_len``, the output lengths, the sessions'
Zipf skew and the store's deployment.  Set-up draws the weights, builds
the scheduler and a store, and runs a few steps whose requests finish and
persist (warm-up); then the scheduler starts over at position 0 on an
empty store.  The window admits at every step boundary from a queue kept
full, and closes at the first step boundary after ``seconds``.

``decode_tokens_per_s``: tokens generated in the window over its seconds.
``tpot_p95_ms``: the 95th percentile of every gap between two tokens of
one request; a gap is the host clock from the end of the step that gave
one token (its ``.tolist()`` synchronises, its persists follow) to the end
of the step that gave the next.

Checked once the window has closed, the peak memory is read and the
scheduler's cache is freed: (1) every session written is read back at
the mix's read quorum and holds the last record written to it, the
tokens its request was served (siblings count as written); (2) the slot
holding the longest finished request and others drawn from the seed (the
check file's ``sample``; every slot where it reaches the slots): all their
served tokens, and their logits at one step in the mix's ``record_every``
(kept in the window by a pass-through around the decode step), against
the reference run over each slot's tokens from position 0 (all slots
share one position, so a request admitted to a slot decodes after what
the slot held before it; the MoE groups are single tokens, as in the
decode step), over all the rows and slot by slot.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import traffic
from .check import Outcome, gaps, rel_errs, summary, worst_group
from .model import draw_weights, program_config, sync
from .spec import reference
from .trace import trace

SLOT_STREAM, RECORD_STREAM = 13, 14
WARM_STEPS = 6
SLOTS_A_BLOCK = 4


class TimedStore:
    """The ``KVCluster`` the scheduler is handed, passed through: each
    GET and PUT is timed on the host, and each key's last record kept."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.persist_s = []
        self.written = {}
        self._get_s = 0.0

    def get(self, key, **kw):
        t = time.perf_counter()
        res = self.cluster.get(key, **kw)
        self._get_s = time.perf_counter() - t
        return res

    def put(self, key, value, **kw):
        t = time.perf_counter()
        ack = self.cluster.put(key, value, **kw)
        self.persist_s.append(self._get_s + time.perf_counter() - t)
        self.written[key] = value
        return ack

    def __getattr__(self, name):
        return getattr(self.cluster, name)


def make_store(mix, seed: int, device):
    from repro_torch.core import DVV_MECHANISM
    from repro_torch.store import KVCluster, SimNetwork
    st = mix["store"]
    return KVCluster(tuple(f"n{i}" for i in range(st["nodes"])),
                     DVV_MECHANISM, replication=st["n_val"],
                     read_quorum=st["r"], write_quorum=st["w"],
                     network=SimNetwork(seed=seed % 2 ** 32, jitter=0.0),
                     seed=seed % 2 ** 32, device=device)


def slot_history(reqs, end: int):
    """A slot's fed and served tokens at positions 0..end-1 from its
    requests [(request, start position)]."""
    fed = np.zeros(end, np.int64)
    served = np.zeros(end, np.int64)
    for r, start in reqs:
        n = min(len(r.generated), end - start)
        if n <= 0:
            continue
        fed[start] = r.prompt_token
        fed[start + 1:start + n] = r.generated[:n - 1]
        served[start:start + n] = r.generated[:n]
    return fed, served


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> Outcome:
    from repro_torch.launch.serve import BatchScheduler, Request

    out = Outcome()
    out.at_s["port_imports"] = time.perf_counter() - t0
    model, mix = cell.config["model"], cell.mix
    cfg = program_config(cell.config)
    params = draw_weights(cfg, cell.config, seed, device)
    sync(device)
    out.at_s["weights"] = time.perf_counter() - t0
    slots, max_len, node = mix["slots"], mix["max_len"], mix["store"]["via"]
    sched = BatchScheduler(cfg, params, slots, max_len,
                           TimedStore(make_store(mix, seed, device)), node)
    sync(device)
    out.at_s["scheduler_and_store"] = time.perf_counter() - t0
    warm = [Request(rid=-1 - k, prompt_token=k, max_tokens=2 + k % 3)
            for k in range(2 * slots)]
    for _ in range(WARM_STEPS):
        sched.admit(warm)
        sched.step()
    sched.pos = 0
    sched.slot_req = [None] * slots
    for layer in sched.cache.values():
        for leaf in layer.values():
            leaf.zero_()
    store = TimedStore(make_store(mix, seed, device))
    sched.store = store
    sync(device)
    out.e2e["setup_s"] = out.at_s["warm_up"] = time.perf_counter() - t0

    stream = traffic.decode_requests(mix, seed, model["vocab_size"])
    queue, started, by_slot = [], {}, [[] for _ in range(slots)]

    def admit():
        while len(queue) < slots:
            rid, first, n = next(stream)
            queue.append(Request(rid=rid, prompt_token=first, max_tokens=n))
        sched.admit(queue)
        for slot, r in enumerate(sched.slot_req):
            if r is not None and id(r) not in started:
                started[id(r)] = sched.pos
                by_slot[slot].append((r, sched.pos))

    # a pass-through around the decode step that keeps its logits (all
    # slots, a device copy) at one step in the mix's ``record_every``, from
    # an offset drawn from the seed
    program_step, recorded = sched._step, {}
    every = mix["record_every"]
    offset = int(traffic.rng(seed, RECORD_STREAM).integers(every))

    def keeping(params, cache, toks, pos):
        logits, cache = program_step(params, cache, toks, pos)
        if pos % every == offset:
            recorded[pos] = logits.clone()
        return logits, cache

    sched._step = keeping
    tpot, tokens, steps = [], 0, 0
    start = last = time.perf_counter()
    while True:
        admit()
        live = [r for r in sched.slot_req if r is not None]
        following = sum(started[id(r)] < sched.pos for r in live)
        sched.step()
        now = time.perf_counter()
        tpot.extend([now - last] * following)
        last = now
        tokens += len(live)
        steps += 1
        if sched.pos >= max_len - 1:
            raise RuntimeError(f"the cache is full at position {sched.pos} "
                               f"of {max_len}: the window needs a larger "
                               f"max_len")
        if now - start >= seconds:
            break
    window_s = now - start
    sched._step = program_step
    out.at_s["window"] = time.perf_counter() - t0
    window_end = sched.pos
    persists = list(store.persist_s)
    out.attempted = len(persists)
    out.e2e["decode_tokens_per_s"] = tokens / window_s
    out.e2e["tpot_p95_ms"] = float(np.percentile(tpot, 95)) * 1e3
    out.layer.update(kind="decode", device_type=device.type, model=model,
                     window_s=window_s, steps=steps, tokens=tokens,
                     persist_s=persists)

    if traced:
        n = mix["trace_steps"]

        def segment():
            for _ in range(n):
                admit()
                sched.step()

        out.segment = trace(segment, {
            "scheduler.step": (sched, "step"),
            "decode_step": (sched, "_step"),
            "session_persist": (sched, "_persist"),
            "scheduler.admit": (sched, "admit")}, device)
        out.layer.update(segment=out.segment, segment_steps=n)
    out.at_s["trace"] = time.perf_counter() - t0
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    sched.cache = None
    del sched
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (1) every session's last record, read back at the read quorum
    expect = {}            # key -> (position, slot, request) of its last
    for slot, slot_reqs in enumerate(by_slot):
        for r, s in slot_reqs:
            key = f"session/{r.rid}"
            if r.done and (s + r.max_tokens, slot) > expect.get(
                    key, (-1, -1, None))[:2]:
                expect[key] = (s + r.max_tokens, slot, r)
    missing = 0
    for key, (end, _, r) in expect.items():
        res = store.cluster.get(key, via=node, quorum=mix["store"]["r"])
        records = [json.loads(v) for v in res.values]
        if {"tokens": r.generated, "pos": end} not in records:
            missing += 1
    out.numbers["session_records_missing"] = float(missing)
    out.numbers["sessions_read_back"] = float(len(expect))

    # (2) the sampled slots' served tokens against the reference; with no
    # finished request the numbers stay unread, and the run not correct
    done = [(len(r.generated), slot, s + len(r.generated))
            for slot, reqs in enumerate(by_slot) for r, s in reqs
            if r.done and s + len(r.generated) <= window_end]
    if done:
        compare_slots(out, cell, params, by_slot, done, recorded, seed,
                      device, control)
    recorded.clear()
    out.at_s["reference"] = time.perf_counter() - t0
    return out


def compare_slots(out, cell, params, by_slot, done, recorded, seed, device,
                  control):
    """The slot of the longest finished request and ``sample - 1`` others
    drawn from the seed (every slot where ``sample`` reaches the slots):
    their served tokens' gaps and their kept logits' errors, over all and
    slot by slot, against the reference over each slot's history,
    ``SLOTS_A_BLOCK`` slots a reference call so that its logits fit."""
    model = cell.config["model"]
    ends = {}
    for _, slot, end in done:
        ends[slot] = max(ends.get(slot, 0), end)
    longest = max(done)[1]
    others = sorted(set(ends) - {longest})
    pick = traffic.rng(seed, SLOT_STREAM).choice(
        others, size=min(cell.check["sample"] - 1, len(others)),
        replace=False)
    chosen = sorted([longest, *map(int, pick)])
    Ref = reference(cell)
    sides = {"program": Ref(model, params)}
    if control:
        sides["control"] = Ref(model, params, "fp8")
    found = {side: {"gap": [], "err": []} for side in sides}
    slot_of = {"gap": [], "err": []}
    for a in range(0, len(chosen), SLOTS_A_BLOCK):
        block = chosen[a:a + SLOTS_A_BLOCK]
        hist = [slot_history(by_slot[s], ends[s]) for s in block]
        seqs = [torch.from_numpy(f).to(device) for f, _ in hist]
        keep = [torch.arange(len(f), device=device) for f, _ in hist]
        served = torch.from_numpy(
            np.concatenate([v for _, v in hist])).to(device)
        rows = [(i, p) for i, s in enumerate(block)
                for p in sorted(recorded) if p < ends[s]]
        starts = np.cumsum([0] + [len(f) for f, _ in hist])
        at = torch.tensor([int(starts[i]) + p for i, p in rows],
                          device=device, dtype=torch.long)
        want = torch.cat(sides["program"].logits(seqs, keep,
                                                 per_token_groups=True))
        got = torch.stack([recorded[p][block[i]] for i, p in rows]) \
            if rows else None
        slot_of["gap"].append(torch.cat([torch.full((len(f),), s) for s, (
            f, _) in zip(block, hist)]))
        slot_of["err"].append(torch.tensor([block[i] for i, _ in rows],
                                           dtype=torch.long))
        for side, ref in sides.items():
            if side == "program":
                tokens, kept = served, got
            else:
                low = torch.cat(ref.logits(seqs, keep,
                                           per_token_groups=True))
                tokens, kept = low.argmax(-1), low[at]
                del low
            found[side]["gap"].append(gaps(want, tokens).cpu())
            if rows:
                found[side]["err"].append(rel_errs(kept, want[at]).cpu())
        del want, got, kept
    out.numbers["tokens_compared"] = float(sum(map(len, slot_of["gap"])))
    out.numbers["rows_compared"] = float(sum(map(len, slot_of["err"])))
    for side, numbers in (("program", out.numbers),
                          ("control", out.control)):
        if side not in found:
            continue
        for kind, name in (("gap", "token_gap"), ("err", "logit_err")):
            if found[side][kind]:
                values = torch.cat(found[side][kind])
                groups = torch.cat(slot_of[kind])
                numbers.update(summary(name, values))
                numbers.update(worst_group(name, values, groups))
