"""Scalar and image logging: JSONL always, TensorBoard when it imports (a
copy of `nerf_from_image_tpu/utils/logging.py`, which the port may not
import, for local directories).

Every scalar goes to `scalars.jsonl` in the log dir, and to TensorBoard
through `torch.utils.tensorboard` when the `tensorboard` package is
installed; a TensorBoard writer that fails to start is warned about, not
swallowed. Images go to TensorBoard, or without it to one PNG strip per
tag and step in the log dir (written by `data/image_io.py`). On several
ranks only rank 0 has a writer (`open_writer`); the others log nowhere.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from nerf_from_image_tpu_torch.data import image_io
from nerf_from_image_tpu_torch.parallel import distributed


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, 'scalars.jsonl'), 'a')
        self._tb = None
        try:
            from torch.utils import tensorboard
            self._tb = tensorboard.SummaryWriter(log_dir)
        except ImportError:
            pass  # no tensorboard package: JSONL only.
        except Exception as e:
            print(f'WARNING: TensorBoard writer init failed for {log_dir!r}: '
                  f'{e!r}; scalars go to JSONL only.', file=sys.stderr,
                  flush=True)

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(json.dumps({'tag': tag, 'value': value,
                                      'step': int(step),
                                      'time': time.time()}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_images(self, tag: str, images, step: int):
        """images: (N, C, H, W) in [0, 1], C 1 or 3."""
        images = np.asarray(images, dtype=np.float32)
        if self._tb is not None:
            self._tb.add_images(tag, torch.from_numpy(images), step)
            return
        arr = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        strip = arr.transpose(0, 2, 3, 1).reshape(-1, arr.shape[3],
                                                  arr.shape[1])
        image_io.write_png(os.path.join(
            self.log_dir, f'{tag.replace("/", "_")}_{step}.png'), strip)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """The writer of a rank that writes nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def add_images(self, tag: str, images, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def open_writer(log_dir: str):
    """A `SummaryWriter` on rank 0 (making `log_dir`), a `NullWriter` on
    the other ranks."""
    if distributed.is_main_process():
        return SummaryWriter(log_dir)
    return NullWriter()
