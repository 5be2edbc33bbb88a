"""A traced segment: ``torch.profiler`` (CUPTI) over a callable, with the
benchmark's own ranges around the port's functions, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

``ranges`` wraps each ``getattr(module, name)`` in a
``torch.profiler.record_function`` range while the segment runs (the
callers look the names up in their modules at each call), as
``chip_smoke.profiler_ranges`` does.  The hand-written kernels are
launched through ctypes and so sit under no host op: they are counted by
kernel name.
"""
from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Tuple

import torch


@contextmanager
def ranges(targets: Mapping[str, Tuple[object, str]]):
    """Run each function ``getattr(module, name)`` of ``targets`` ({label:
    (module, name)}) inside a profiler range ``label`` while open."""
    saved = []
    for label, (module, name) in targets.items():
        fn = getattr(module, name)

        def ranged(*args, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)

        saved.append((module, name, fn))
        setattr(module, name, ranged)
    try:
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def bare_name(key: str) -> str:
    """A kernel's name without namespace, template arguments or
    parameters (``void (anonymous namespace)::flash_fwd_bf16_kernel<128,
    false>(...)`` -> ``flash_fwd_bf16_kernel``)."""
    s = key.replace("(anonymous namespace)::", "")
    prev = None
    while prev != s:                  # innermost template arguments first
        prev, s = s, re.sub(r"<[^<>]*>", "", s)
    s = s.split("(", 1)[0].strip()
    s = s[len("void "):] if s.startswith("void ") else s
    return s.rsplit("::", 1)[-1].strip() or key[:80]


@dataclass
class Segment:
    """What one traced segment read: ``window_s`` of host clock from the
    profiler's start to the device's last work, ``busy_s`` the union of
    the device's operations in it, ``device_ops`` device seconds by bare
    kernel name, ``under`` device seconds of the kernels each range's host
    ops launched (nested ranges included), ``idle_gaps`` the device's idle
    seconds by the innermost range the host was in."""
    window_s: float
    busy_s: float
    device_ops: Dict[str, float] = field(default_factory=dict)
    under: Dict[str, float] = field(default_factory=dict)
    idle_gaps: Dict[str, float] = field(default_factory=dict)

    def kernel_s(self, part: str) -> float:
        return sum(s for k, s in self.device_ops.items() if part in k)


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def trace(fn: Callable[[], None], targets: Mapping[str, Tuple[object, str]],
          device) -> Segment:
    """Run ``fn`` once under the profiler with ``targets``' ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with ranges(targets), profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t
    events = prof.events()
    labels = set(targets)
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name in labels or getattr(e, "is_user_annotation", False):
                continue                      # a range's device-side row
            dev.append(e)
        elif e.device_type == DeviceType.CPU and e.name in labels:
            host.append(e)
    seg = Segment(window_s=window_s, busy_s=0.0)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = _union(spans)
    seg.busy_s = sum(b - a for a, b in busy) / 1e6
    for e in dev:
        name = bare_name(e.name)
        seg.device_ops[name] = seg.device_ops.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6

    def kernels_under(e):
        yield from e.kernels
        for child in e.cpu_children:
            yield from kernels_under(child)

    for e in host:
        seg.under[e.name] = seg.under.get(e.name, 0.0) + sum(
            k.duration for k in kernels_under(e)) / 1e6
    # the device's idle gaps inside the segment, each put down to the
    # innermost range that held the host at the gap's middle
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        label = "outside the ranges"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if host[i].time_range.end >= mid:
                label = host[i].name
                break
            i -= 1
        seg.idle_gaps[label] = seg.idle_gaps.get(label, 0.0) + (b - a) / 1e6
    return seg


def top(d: Mapping[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
