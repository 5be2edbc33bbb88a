"""Hand-written Hopper kernels for the framework's compute hot-spots.

Each kernel ships in the JAX package's layout: <name>/<name>.py builds and
launches the CUDA source under <name>/csrc/, <name>/ops.py holds the public
functions (the kernel for CUDA tensors, the plain torch version for CPU
tensors), and <name>/ref.py the plain torch versions:

  * dvv_ops — batched dotted-version-vector dominance (the paper's clock
              algebra, vectorized for anti-entropy and quorum reads)
"""
from . import dvv_ops

__all__ = ["dvv_ops"]
