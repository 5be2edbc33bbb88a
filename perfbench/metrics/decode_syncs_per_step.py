"""decode_syncs_per_step: blocking CUDA runtime calls
(``bench/spans.py``'s ``SYNC_CALLS``: stream, device and event
synchronisations, synchronous copies) made inside the program's
``serve.step`` span, a step, in segment (C): the program's tracing on
under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "decode":
        return None
    c = spans.segments(run).get("C")
    if not c or not c["spans"].get("serve.step"):
        return None
    return float(c["syncs"].get("serve.step", 0)) / c["spans"]["serve.step"]
