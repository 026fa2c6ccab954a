"""Tensor ops and the hand-written CUDA kernels."""
