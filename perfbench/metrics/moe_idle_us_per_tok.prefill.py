"""moe_idle_us_per_tok.prefill: the device's idle microseconds while the
host was innermost in the program's ``lm.moe`` span or one of its parts
(``lm.moe.route``, ``.assign``, ``.dispatch``, ``.experts``,
``.combine``), a prompt token, over the block of prompts of segment (C)
of ``bench/spans.py``: the program's tracing on under the profiler."""
from perfbench.bench import spans


def read(run):
    if run.get("kind") != "prefill":
        return None
    found = spans.segments(run)
    c = found.get("C")
    if not c or not c["spans"].get("lm.moe"):
        return None
    idle = sum(s for name, s in c["idle_s"].items()
               if name == "lm.moe" or name.startswith("lm.moe."))
    return idle * 1e6 / sum(found["lengths"])
