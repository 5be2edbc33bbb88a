"""Hand-written Hopper kernels for the framework's compute hot-spots.

Each kernel ships in the JAX package's layout: <name>/<name>.py builds and
launches the CUDA source under <name>/csrc/, <name>/ops.py holds the public
functions (the kernel for CUDA tensors, the plain torch version for CPU
tensors), and <name>/ref.py the plain torch versions:

  * decode_attention — one decode step's attention over the live keys of
                       a KV cache, split over the keys (no TPU kernel: the
                       JAX package's decode attention is jnp)
  * dvv_ops          — batched dotted-version-vector dominance (the paper's
                       clock algebra, vectorized for anti-entropy and quorum
                       reads)
  * flash_attention  — online-softmax attention with GQA, causal and
                       sliding-window masks and a logit softcap, forward
                       (prefill, training) and backward (training)
  * ssd_scan         — the Mamba-2 SSD chunked scan, forward (prefill,
                       training) and backward (training)

``build.py`` compiles each package with ``nvcc`` at first use.
"""
from . import decode_attention, dvv_ops, flash_attention, ssd_scan

__all__ = ["decode_attention", "dvv_ops", "flash_attention", "ssd_scan"]
