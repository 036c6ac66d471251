"""PyTorch/CUDA port of linnaeus_tpu for one NVIDIA H100.

The package mirrors ``linnaeus_tpu``'s layout and holds the JAX package as
its reference: every module here is tested against its counterpart there.
It imports torch and numpy, never jax, flax or linnaeus_tpu. The Pallas
kernels of the serving path are hand-written CUDA kernels under ``csrc/``,
built by ``_kernels.py`` at first use.
"""
