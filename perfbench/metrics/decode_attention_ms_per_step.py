"""decode_attention_ms_per_step: device milliseconds of the operations
launched inside the program's ``lm.decode_attention`` spans (the
projections, RoPE, the cache write, the scores over the whole cache, the
softmax, the output product), a step, in segment (C) of
``bench/spans.py``: the program's tracing on under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "decode":
        return None
    c = spans.segments(run).get("C")
    if not c or not c["device_s"].get("lm.decode_attention"):
        return None
    return sum(c["device_s"]["lm.decode_attention"].values()) * 1e3 / \
        c["spans"]["serve.step"]
