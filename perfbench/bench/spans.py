"""The program's own spans and counters (``repro_torch.runtime.tracing``)
over two more segments of a cell's ``--trace 1`` run, reduced to what the
per-layer metrics that read them need.

The segments follow the benchmark's own traced segment (``trace.py``,
with its ranges, tracing off), which they leave as it is:

* (B), decode cells only: the program's tracing on, no profiler; the host
  clock's statistics of its spans (``tracing.snapshot()``) over
  ``trace_steps`` steps;
* (C), on a card only: the program's tracing on under ``torch.profiler``
  (CUPTI) over the same number of steps, or the same block of prompts as
  the benchmark's own segment: the device time of the operations each
  program span launched (nested spans included), the launches (kernels,
  memcpys, memsets) and the blocking runtime calls made under each span,
  and the device's idle gaps by span (``reduce``: where the host was, or,
  where the host was ahead, which span queued the operation the device
  went on with).

``decode.py`` and ``prefill.py`` free their systems before the readers run
and hand them no live scheduler or step, and this module leaves them as
they are: the first reader that asks builds the cell's system again, as
they do, from the configuration and the seed it finds in ``run.py``'s
frame.  The weights are drawn from the seed; a decode cell gets a
``BatchScheduler`` warmed up as the window's was, fed the cell's traffic
for ``SETTLE_STEPS`` steps (tracing on, so that the store's counters hold
the writes since), then the segments; a prefill cell the block of strata
that the benchmark's own segment traced, after one prompt of it untimed.
The run's ``memory_peak_bytes`` was read before, by ``decode.py`` or
``prefill.py``.  A program without ``repro_torch.runtime.tracing`` gives
nothing to read, and its readers read ``None``; so do they when this
fails, which standard error reports.  Standard error also gets one line,
``program_spans``, with what the segments read.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import itertools
import json
import re
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import traffic
from .model import draw_weights, program_config, sync
from .trace import bare_name

#: Untraced steps of the cell's traffic before the segments: a request of
#: ``decode_short`` lives at most 32 steps.
SETTLE_STEPS = 32
#: Runtime calls that block the host until the device has done its work.
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyHtoD"})
#: Runtime calls that queue a kernel, a memcpy or a memset.
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
OUTSIDE = "outside the program spans"

Mark = Tuple[str, float, float]                  # span: name, start, end
Call = Tuple[str, float, float, int]             # + correlation id
Op = Tuple[str, float, float, int]


class Intervals:
    """The union of one span name's host intervals."""

    def __init__(self, spans: Sequence[Tuple[float, float]]):
        merged: List[List[float]] = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def reduce(marks: Sequence[Mark], calls: Sequence[Call], ops: Sequence[Op]
           ) -> Dict:
    """A profiled segment's events (times in µs on one clock) reduced to:
    ``spans`` (count a name), ``device_s`` ({span: {bare kernel: device
    seconds of the operations launched under it}}), ``launches`` and
    ``syncs`` (runtime calls under each span), ``idle_s`` (the device's
    gaps between its operations by span, ``OUTSIDE`` for none), ``busy_s``,
    and ``unlinked_ops``, the operations whose launch (the runtime call
    with their correlation id) is not in the trace.

    A gap the host made, the operation after it launched during the gap,
    goes to the innermost span holding the host at the gap's middle; a gap
    the device made, the operation after it queued before the gap began
    (the host ahead, waiting elsewhere), goes to the innermost span that
    launched that operation."""
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for name, a, b in marks:
        by_name.setdefault(name, []).append((a, b))
    within = {name: Intervals(v) for name, v in by_name.items()}

    def under(t: float):
        return [name for name, iv in within.items() if t in iv]

    out = {"spans": {n: len(v) for n, v in by_name.items()},
           "device_s": {}, "launches": {}, "syncs": {}, "idle_s": {}}
    for name, a, _, _ in calls:
        kinds = (["launches"] if LAUNCH.match(name) else []) + (
            ["syncs"] if name in SYNC_CALLS else [])
        for kind in kinds:
            for span in under(a):
                out[kind][span] = out[kind].get(span, 0) + 1

    at = {corr: a for name, a, _, corr in calls if LAUNCH.match(name)}
    launched = [at.get(corr) for _, _, _, corr in ops]
    out["unlinked_ops"] = sum(t is None for t in launched)
    for (name, a, b, _), t in zip(ops, launched):
        if t is None:
            continue
        for span in under(t):
            kernels = out["device_s"].setdefault(span, {})
            kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e6

    busy: List[List] = []              # [start, end, launch of the first]
    for i in sorted(range(len(ops)), key=lambda i: ops[i][1]):
        _, a, b, _ = ops[i]
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b, launched[i]])
    out["busy_s"] = sum(b - a for a, b, _ in busy) / 1e6
    nested = sorted(marks, key=lambda m: m[1])
    starts = [m[1] for m in nested]
    reach = list(itertools.accumulate((m[2] for m in nested), max))

    def innermost(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:   # spans nest: the latest-starting
            if nested[i][2] >= t:         # one that holds t is innermost
                return nested[i][0]
            i -= 1
        return OUTSIDE

    for (_, a, _), (b, _, queued) in zip(busy, busy[1:]):
        label = innermost(queued if queued is not None and queued < a
                          else (a + b) / 2)
        out["idle_s"][label] = out["idle_s"].get(label, 0.0) + (b - a) / 1e6
    return out


def events(prof_events, names) -> Tuple[List[Mark], List[Call], List[Op]]:
    """The program spans (``names``), runtime calls and device operations
    of a profiler's events."""
    from torch.autograd import DeviceType
    marks, calls, ops = [], [], []
    for e in prof_events:
        t = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in names or getattr(e, "is_user_annotation", False):
                continue                     # a span's device-side row
            ops.append((bare_name(e.name), t.start, t.end, e.id))
        elif e.name in names:
            marks.append((e.name, t.start, t.end))
        elif RUNTIME.match(e.name):
            calls.append((e.name, t.start, t.end, e.id))
    return marks, calls, ops


def profiled(fn, device) -> Dict:
    """``fn`` once under the profiler with the program's tracing on:
    ``reduce``'s reading and the segment's host seconds (``window_s``)."""
    from repro_torch.runtime import tracing
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            sync(device)
            window_s = time.perf_counter() - t
    finally:
        tracing.disable()
    names = {r.name for r in tracing.drain()}
    return dict(reduce(*events(prof.events(), names)), window_s=window_s)


def _cell_of(run) -> Optional[Tuple[object, int, torch.device, object]]:
    """The cell, seed, device and outcome of the run whose readers hold
    ``run``, from ``run.py``'s frame."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        out = loc.get("out")
        if getattr(out, "layer", None) is run and "cell" in loc:
            return loc["cell"], loc["args"].seed, loc["dev"], out
        f = f.f_back
    return None


def _decode(cell, seed: int, device) -> Dict:
    from repro_torch.launch.serve import BatchScheduler, Request
    from repro_torch.runtime import tracing
    from .decode import WARM_STEPS, make_store
    mix, model = cell.mix, cell.config["model"]
    cfg = program_config(cell.config)
    params = draw_weights(cfg, cell.config, seed, device)
    slots, node = mix["slots"], mix["store"]["via"]
    sched = BatchScheduler(cfg, params, slots, mix["max_len"],
                           make_store(mix, seed, device), node)
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
    store = make_store(mix, seed, device)
    sched.store = store
    stream = traffic.decode_requests(mix, seed, model["vocab_size"])
    queue: List[Request] = []

    def steps(n: int) -> None:
        for _ in range(n):
            while len(queue) < slots:
                rid, first, k = next(stream)
                queue.append(Request(rid=rid, prompt_token=first,
                                     max_tokens=k))
            sched.admit(queue)
            sched.step()

    n = mix["trace_steps"]
    tracing.enable()
    try:
        steps(SETTLE_STEPS)
        sync(device)
        tracing.drain()
        steps(n)
        sync(device)
    finally:
        tracing.disable()
    found = {"steps": n, "B": tracing.snapshot(store)}
    tracing.drain()
    if device.type == "cuda":
        found["C"] = profiled(lambda: steps(n), device)
    return found


def _prefill(cell, seed: int, device, attempted: int) -> Dict:
    from repro_torch.launch.steps import make_prefill_step
    mix, model = cell.mix, cell.config["model"]
    n = mix["strata"]
    first = -(-attempted // n) * n         # the block prefill.py traced
    order = traffic.prompts(mix, seed)
    plan = [next(order) for _ in range(first + n)]
    lengths = plan[first:]
    found = {"lengths": lengths}
    if device.type != "cuda":
        return found
    cfg = program_config(cell.config)
    params = draw_weights(cfg, cell.config, seed, device)
    step = make_prefill_step(cfg)
    inputs = [torch.from_numpy(traffic.prompt_tokens(
        seed, j, plan[j], model["vocab_size"])).to(device)[None]
        for j in range(first, first + n)]

    def segment(prompts):
        for toks in prompts:
            logits = step(params, {"tokens": toks})
            int(torch.argmax(logits[0, -1]))
            del logits

    segment(inputs[:1])
    found["C"] = profiled(lambda: segment(inputs), device)
    return found


def _summary(found: Dict) -> Dict:
    """What the ``program_spans`` line of standard error holds."""
    out = {k: v for k, v in found.items() if k not in ("B", "C")}
    if "B" in found:
        b = found["B"]
        out["B"] = {"spans": b["spans"], "counters": b["counters"],
                    "launches": b["launches"], "store": b.get("store")}
    if "C" in found:
        c = found["C"]
        idle = sum(c["idle_s"].values())
        out["C"] = {k: c[k] for k in ("spans", "launches", "syncs", "idle_s",
                                      "busy_s", "window_s",
                                      "unlinked_ops")}
        out["C"]["device_s"] = {s: sum(k.values())
                                for s, k in c["device_s"].items()}
        out["C"]["top_kernels"] = {
            s: sorted(k.items(), key=lambda kv: -kv[1])[:4]
            for s, k in c["device_s"].items()}
        out["C"]["idle_outside_share"] = c["idle_s"].get(OUTSIDE, 0.0) / \
            idle if idle else None
    return out


def segments(run) -> Dict:
    """The segments' readings for the run ``run`` (``Outcome.layer``,
    which keeps them for the next reader): ``B`` and ``C`` where
    they ran, and ``steps`` (decode) or ``lengths`` (prefill)."""
    if "program_spans" in run:
        return run["program_spans"]
    run["program_spans"] = found = {}
    if importlib.util.find_spec("repro_torch.runtime.tracing") is None:
        return found
    where = _cell_of(run)
    if where is None:
        return found
    cell, seed, device, outcome = where
    t = time.perf_counter()
    try:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if run.get("kind") == "decode":
            found.update(_decode(cell, seed, device))
        elif run.get("kind") == "prefill":
            found.update(_prefill(cell, seed, device, outcome.attempted))
    except Exception:                     # the readers then read None
        traceback.print_exc()
        found.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(json.dumps({"program_spans": dict(
        _summary(found), seconds=time.perf_counter() - t)}),
        file=sys.stderr, flush=True)
    return found
