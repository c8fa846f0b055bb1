"""Scalar logging: JSONL always, TensorBoard when it imports (a copy
of `nerf_from_image_tpu/utils/logging.py`, which the port may not import,
for local directories).

Every scalar goes to `scalars.jsonl` in the log dir, and to TensorBoard
through `torch.utils.tensorboard` when the `tensorboard` package is
installed; a TensorBoard writer that fails to start is warned about, not
swallowed. Image logging waits for its first caller (the GAN eval).
"""

from __future__ import annotations

import json
import os
import sys
import time


class SummaryWriter:
    def __init__(self, log_dir: str):
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

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
