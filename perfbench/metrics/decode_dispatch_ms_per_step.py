"""decode_dispatch_ms_per_step: host milliseconds a decode step spends in
the program's ``serve.step.dispatch`` span (building the tokens, queueing
the model's step and the argmax, and whatever the host waits for on the
way), averaged over the steps of segment (B) of ``bench/spans.py``: the
program's tracing on, no profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "decode":
        return None
    b = spans.segments(run).get("B")
    stats = b["spans"].get("serve.step.dispatch") if b else None
    if not stats:
        return None
    return stats["total_s"] * 1e3 / stats["count"]
