"""PyTorch/CUDA port of `dp_gp_lvm_tpu`.

Mirrors the JAX package's layout module for module. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package become hand-written CUDA
kernels under `csrc/`, built with nvcc at first use (`ops/build.py`).
This package imports neither `jax` nor `dp_gp_lvm_tpu`.
"""
