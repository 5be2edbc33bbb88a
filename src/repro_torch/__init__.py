"""PyTorch port of the DVV replicated store (``src/repro``), with
hand-written CUDA kernels for Hopper.  Imports neither ``jax`` nor
``repro``; each module mirrors the JAX package's module of the same path."""
