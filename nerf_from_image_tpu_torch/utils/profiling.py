"""On-demand profiler traces (PyTorch port of the `trace` context of
`nerf_from_image_tpu/utils/profiling.py`).

`trace(log_dir)` records what runs inside it with `torch.profiler`: the
host's operators always, and the card's kernels (CUPTI) when the traced
work runs on the card. On exit it writes one Chrome trace,
`<log_dir>/<host>.<pid>.<ms>.pt.trace.json`, which Perfetto
(ui.perfetto.dev) or `chrome://tracing` opens; each kernel appears there
by its CUDA function name (`triplane_sample_kernel`, ...).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import torch

TRACE_SUFFIX = '.pt.trace.json'


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True,
          device: Optional[torch.device] = None):
    """Traces the enclosed steps into one Chrome trace under `log_dir`.

    `device` is where the traced work runs: CUDA activity is recorded
    for a CUDA device (None: when a card is present), CPU activity
    always. The caller synchronises the card inside the context, so the
    trace holds the kernels it launched.

        with profiling.trace('gan_logs/exp/trace', i == 2, device):
            metrics = g_step(state, batch, cfg)
            torch.cuda.synchronize(device)
    """
    if not enabled:
        yield None
        return
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == 'cuda')
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f'{socket.gethostname()}.{os.getpid()}.'
                        f'{int(time.time() * 1000)}{TRACE_SUFFIX}')
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
