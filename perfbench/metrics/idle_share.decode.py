"""idle_share.decode: the share of the traced segment's host-clock window
in which no operation ran on the device."""


def read(run):
    seg = run.get("segment")
    if run.get("kind") != "decode" or seg is None or not seg.busy_s:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
