"""Device resolution for the port's entry points: CUDA unless asked.

`device=None` means the card. When CUDA is absent the call raises instead
of dropping to the CPU; the CPU runs only when the caller names it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Returns the torch.device an entry point runs on.

    Raises RuntimeError when `device` is None or names CUDA and no CUDA
    device is available.
    """
    resolved = torch.device('cuda' if device is None else device)
    if resolved.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return resolved
