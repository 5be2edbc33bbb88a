"""flash_roofline.prefill: the flash forward kernel's share of its
roofline over the traced prompts: the sum over its launches, one an
attention layer a prompt, of the least time the card could take
(``peaks.bound_s`` of each launch's operations on the pairs its layer's
mask keeps and its bytes, q, k, v and the output once) over the device
time of the kernels named ``flash_fwd``."""
from collections import Counter

from perfbench.bench import peaks


def read(run):
    seg = run.get("segment")
    if run.get("kind") != "prefill" or seg is None:
        return None
    spent = seg.kernel_s("flash_fwd")
    if not spent:
        return None
    model = run["model"]
    layers = Counter(peaks.attention_windows(model))
    least = 0.0
    for S in run["segment_lengths"]:
        for window, n in layers.items():
            flops, nbytes = peaks.flash_launch(model, S, window)
            least += n * peaks.bound_s(nbytes, flops)[0]
    return 100.0 * least / spent
