"""Attention kernels: CUDA sources in ``csrc/``, built with nvcc on first
use (``_build``), each beside its plain PyTorch version."""
