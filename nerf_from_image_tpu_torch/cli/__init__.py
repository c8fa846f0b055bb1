"""Command-line entry points: `python -m nerf_from_image_tpu_torch.cli.run`."""
