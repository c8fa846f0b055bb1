"""Ray, sampling and compositing math (PyTorch port of the JAX `core/`)."""
