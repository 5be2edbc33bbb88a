"""attention_glue_us_per_tok.prefill: device microseconds of the
operations launched inside the program's ``lm.attention`` spans other
than the flash kernel (``flash_fwd``): the q, k, v and output
projections, RoPE and the layout copies, a prompt token, over the block
of prompts of segment (C) of ``bench/spans.py``: the program's tracing on
under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "prefill":
        return None
    found = spans.segments(run)
    kernels = found.get("C", {}).get("device_s", {}).get("lm.attention")
    if not kernels:
        return None
    glue = sum(s for k, s in kernels.items() if "flash_fwd" not in k)
    return glue * 1e6 / sum(found["lengths"])
