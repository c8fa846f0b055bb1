"""Resampling and triplane ops; CUDA kernels live under `csrc/`."""
