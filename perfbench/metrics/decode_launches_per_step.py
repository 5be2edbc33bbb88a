"""decode_launches_per_step: kernels, memcpys and memsets queued (runtime
calls matching ``bench/spans.py``'s ``LAUNCH``) inside the program's
``serve.step`` span, a step, in segment (C): the program's tracing on
under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "decode":
        return None
    c = spans.segments(run).get("C")
    if not c or not c["launches"].get("serve.step"):
        return None
    return float(c["launches"]["serve.step"]) / c["spans"]["serve.step"]
