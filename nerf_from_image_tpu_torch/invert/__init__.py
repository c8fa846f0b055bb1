"""Hybrid inversion (PyTorch port of `nerf_from_image_tpu/invert/`)."""
