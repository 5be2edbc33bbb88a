"""mfu.prefill: the model operations the window's prompts need
(``peaks.prefill_flops``: linear layers with a MoE's routed experts only,
causal attention) over the window's seconds, as a share of the H100's
dense bf16 peak.  Read on a card only."""
from perfbench.bench import peaks


def read(run):
    if run.get("kind") != "prefill" or run.get("device_type") != "cuda":
        return None
    return 100.0 * run["flops"] / run["window_s"] / peaks.PEAK_BF16_FLOPS
