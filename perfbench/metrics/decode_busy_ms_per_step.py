"""decode_busy_ms_per_step: device-busy milliseconds a decode step, the
union of the device's operations over the traced steps (CUPTI) divided
by the steps."""


def read(run):
    seg = run.get("segment")
    if run.get("kind") != "decode" or seg is None or not seg.busy_s:
        return None
    return seg.busy_s * 1e3 / run["segment_steps"]
