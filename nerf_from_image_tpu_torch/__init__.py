"""PyTorch/CUDA port of `nerf_from_image_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(`core/`, `ops/`, `models/`, `render/`, `utils/`) and its function names.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper (`ops/csrc/*.cu`), built with
`nvcc` at its first CUDA call and loaded through `ctypes`.

Importing this package imports `torch` and numpy only. Entry points run on
the card unless the caller passes `device='cpu'` (see `device.py`).
"""

__version__ = "0.1.0"
