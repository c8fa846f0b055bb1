"""The reference's device argument: a name or a torch.device, CPU when
None (the reference never picks the card by itself)."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    return torch.device('cpu' if device is None else device)
