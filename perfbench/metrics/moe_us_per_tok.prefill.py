"""moe_us_per_tok.prefill: device microseconds of the kernels launched
under the ``moe_ffn`` range (routing, capacity assignment, dispatch,
experts, combine) per prompt token of the traced prompts."""


def read(run):
    seg = run.get("segment")
    if run.get("kind") != "prefill" or seg is None or \
            not seg.under.get("moe_ffn"):
        return None
    return seg.under["moe_ffn"] * 1e6 / sum(run["segment_lengths"])
