"""Operators: matmul, attention and the CUDA kernels' wrappers."""
