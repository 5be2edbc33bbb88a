"""Spans and counters on the port's hot path, off unless ``enable()``.

    from repro_torch.runtime import tracing
    tracing.enable()
    ...                               # serve, prefill, store operations
    stats = tracing.snapshot(cluster)  # per span name, and the counters
    records = tracing.drain()          # every span, then none kept

``span(name, **ids)`` is a context manager at the places where the work
happens: the serving loop (``launch/serve.py``: ``serve.step``,
``serve.step.dispatch``, ``serve.step.sync``, ``serve.persist``,
``serve.admit``), the model (``models/lm.py``: ``lm.forward``,
``lm.decode_step``, ``lm.embed``, ``lm.layer``, ``lm.attention``,
``lm.decode_attention``, ``lm.mamba``, ``lm.mlp``, ``lm.moe`` and its
parts ``lm.moe.route``, ``.assign``, ``.dispatch``, ``.experts``,
``.combine``, ``lm.head``) and the store (``store/cluster.py``:
``store.get``, ``store.get.merge``, ``store.put``,
``store.put.coordinate``, ``store.put.replicate``).

Off (the default), ``span`` checks one module-level flag and returns one
shared no-op context: no record, no clock read.  On, each span appends a
``Record``: its name, ``time.perf_counter_ns()`` at start and end, the
index of the span open around it (-1 for none) and its ids (a finished
request's ``serve.persist`` carries its ``rid``, a serving step's
``serve.step`` its ``pos``).  While a ``torch.profiler`` runs, a span also
opens ``torch.profiler.record_function(name)``, so that it lies on the
device trace's own timeline.  Spans nest by the order they open and close,
in one thread: the port's serving loop runs in one.

``count(name, n)`` adds ``n`` to a counter while tracing is on: a host
int, or a device tensor, kept as it is and summed once, in ``snapshot()``
(nothing is read back from the device on the hot path).  The counters:

* ``moe.pairs_routed``, ``moe.pairs_kept``: (token, slot) pairs the MoE
  routed and those its capacity kept (``models/moe.py``'s ``assign``);
* ``store.replication_queued``: replication messages a PUT (or a read
  repair) queued on the network and counted as acknowledged;
  ``store.replication_delivered``: those ``deliver_replication`` applied;
  their difference is the backlog of acknowledged copies not yet on their
  replicas;
* ``store.siblings_returned``: values the GETs returned;
* ``decode_attention.keys_read``, ``decode_attention.keys_cached``: the
  live keys decode attention read and the keys its caches held
  (``kernels/decode_attention/ops.py``); their ratio is the share of the
  cache read.

``snapshot()`` also reads, where they are kept, the kernels' launch
counters (``kernels/*``'s ``launches`` dicts), the seconds of their
builds (``kernels/build.py``'s ``build_info``) and, given a ``KVCluster``,
its plane counters.

Serving prints the snapshot as JSON with ``--trace``:
``python -m repro_torch.launch.serve --arch <arch> --trace``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

__all__ = ["Record", "span", "count", "enable", "disable", "drain",
           "snapshot"]

#: Tensors added to one counter are summed into one after this many.
FOLD = 256

_on = False
_records: List["Record"] = []
_open: List[int] = []
_counts: Dict[str, int] = {}
_pending: Dict[str, List[torch.Tensor]] = {}
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class Record:
    """One span: ``end_ns`` is 0 while it is open; ``parent`` indexes the
    record of the span open around it (-1 for none)."""
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1
    ids: Dict[str, Any] = field(default_factory=dict)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("record", "range")

    def __init__(self, name: str, ids: Dict[str, Any]):
        self.record = Record(name, 0, ids=ids)
        self.range = None

    def __enter__(self) -> Record:
        rec = self.record
        if _profiling():
            self.range = torch.profiler.record_function(rec.name)
            self.range.__enter__()
        rec.parent = _open[-1] if _open else -1
        _open.append(len(_records))
        _records.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        self.record.end_ns = time.perf_counter_ns()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **ids):
    """A context over the work ``name`` names (see the module's list)."""
    if not _on:
        return _OFF
    return _Span(name, ids)


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a tensor read in ``snapshot``) to ``name``."""
    if not _on:
        return
    if isinstance(n, torch.Tensor):
        kept = _pending.setdefault(name, [])
        kept.append(n.detach())
        if len(kept) >= FOLD:
            _pending[name] = [torch.stack(kept).sum(0)]
        return
    _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    """Turn tracing on, from no records and zero counts."""
    global _on
    _records.clear()
    _open.clear()
    _counts.clear()
    _pending.clear()
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until ``drain``."""
    global _on
    _on = False


def drain() -> List[Record]:
    """The records kept so far, in the order their spans opened; none is
    kept after.  Call it where no span is open."""
    out = list(_records)
    _records.clear()
    _open.clear()
    return out


#: The kernels' launch counters: {module under ``kernels``: its dicts}.
_LAUNCH_DICTS = {
    "decode_attention.decode_attention": ("launches",),
    "dvv_ops.dvv_ops": ("launches", "path_launches"),
    "flash_attention.flash_attention": ("launches", "instance_launches",
                                        "bwd_launches"),
    "ssd_scan.ssd_scan": ("launches", "path_launches", "bwd_launches"),
}


def _kernel_counters() -> Dict[str, Dict]:
    from importlib import import_module
    from ..kernels import build
    launches = {}
    for module, names in _LAUNCH_DICTS.items():
        mod = import_module(f"{__package__.rsplit('.', 1)[0]}.kernels."
                            f"{module}")
        for name in names:
            launches[f"{module.split('.')[0]}.{name}"] = dict(
                getattr(mod, name))
    builds = {name: info["seconds"] for name, info in build.build_info.items()}
    return {"launches": launches, "build_s": builds}


def snapshot(cluster=None) -> Dict[str, Any]:
    """What the records and counters hold now: per span name its
    ``count``, ``total_s``, ``max_s`` and ``self_s`` (each span's duration
    less its child spans'), over the closed spans; the counters (device
    tensors summed and read here); the kernels' launch counters and build
    seconds; and, given a ``KVCluster``, its plane counters."""
    covered = [0] * len(_records)
    for rec in _records:
        if rec.end_ns and rec.parent >= 0:
            covered[rec.parent] += rec.end_ns - rec.start_ns
    spans: Dict[str, Dict[str, float]] = {}
    for rec, child_ns in zip(_records, covered):
        if not rec.end_ns:
            continue
        s = (rec.end_ns - rec.start_ns) / 1e9
        stats = spans.setdefault(rec.name, {"count": 0, "total_s": 0.0,
                                            "max_s": 0.0, "self_s": 0.0})
        stats["count"] += 1
        stats["total_s"] += s
        stats["max_s"] = max(stats["max_s"], s)
        stats["self_s"] += s - child_ns / 1e9
    counters: Dict[str, int] = dict(_counts)
    for name, kept in _pending.items():
        counters[name] = counters.get(name, 0) + int(torch.stack(kept).sum())
    out: Dict[str, Any] = {"spans": spans, "counters": counters,
                           **_kernel_counters()}
    if cluster is not None:
        out["store"] = {"plane_reads": cluster.plane_reads,
                        "plane_writes": cluster.plane_writes}
    return out
