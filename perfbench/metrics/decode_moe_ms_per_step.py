"""decode_moe_ms_per_step: device milliseconds of the operations launched
inside the program's ``lm.moe`` spans (routing, capacity assignment,
dispatch, the experts, combine, the aux losses), a step, in segment (C)
of ``bench/spans.py``: the program's tracing on under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "decode":
        return None
    c = spans.segments(run).get("C")
    if not c or not c["device_s"].get("lm.moe"):
        return None
    return sum(c["device_s"]["lm.moe"].values()) * 1e3 / \
        c["spans"]["serve.step"]
