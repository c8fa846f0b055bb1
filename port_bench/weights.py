"""Seeded weights, made on the device in one draw per model.

No published weights are in the repository, so every model of a run
takes values drawn from the run's seed: one `torch.randn` of all of a
model's parameters on the card from a `torch.Generator` seeded there,
each parameter's slice scaled to the spread of the module's own
initialisation (its constructed values' standard deviation, and for a
vector their mean; a constant parameter, such as a layer norm's weight,
keeps its constructed value). Buffers are not drawn.

A configuration may state the value of a leaf that a trained model has
learnt and a random one lacks (`set_leaves`: the SDF field's density
scale, so that surfaces are opaque), and the leaves that the model keeps
non-negative (`non_negative_leaves`: LPIPS's 'lin' weights, without which
the distance takes either sign). `Recipe.of(module)` reads the
spreads; `recipe.draw(seed, device)` makes
the state dict, the same tensors for the same seed, so the program's
modules load it in set-up and the reference's load it again once the
window has closed, without a second copy held through the window.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


def sub_seed(seed: int, k: int) -> int:
    """The seed of a run's k-th draw, within a generator's 63 bits."""
    return (int(seed) * 1_000_003 + 7919 * k) % (2**63 - 1)


@dataclasses.dataclass
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float
    mean: float
    constant: Optional[torch.Tensor]  # the value of a leaf not drawn


@dataclasses.dataclass
class Recipe:
    leaves: List[Leaf]
    # Leaves given a stated value (the configuration's `set_leaves`).
    set_leaves: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Name prefixes of leaves drawn non-negative (`non_negative_leaves`).
    non_negative: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    @torch.no_grad()
    def of(cls, module: nn.Module,
           set_leaves: Optional[Dict[str, float]] = None,
           non_negative: Optional[List[str]] = None) -> 'Recipe':
        leaves = []
        for name, p in sorted(module.named_parameters(),
                              key=lambda kv: kv[0]):
            v = p.detach().float()
            std = float(v.std()) if v.numel() > 1 else 0.0
            mean = float(v.mean()) if p.ndim < 2 else 0.0
            leaves.append(Leaf(name, tuple(p.shape), p.dtype, std, mean,
                               None if std else p.detach().clone()))
        return cls(leaves, dict(set_leaves or {}), list(non_negative or []))

    @torch.no_grad()
    def draw(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """{name: tensor} of every parameter, from one draw on `device`;
        the leaves named in `set_leaves` take the value given there."""
        drawn = [leaf for leaf in self.leaves if leaf.std]
        total = sum(int(torch.Size(leaf.shape).numel()) for leaf in drawn)
        gen = torch.Generator(device=device).manual_seed(seed)
        flat = torch.randn((total,), generator=gen, device=device)
        out, at = {}, 0
        for leaf in self.leaves:
            if not leaf.std:
                out[leaf.name] = leaf.constant.to(device)
                continue
            n = int(torch.Size(leaf.shape).numel())
            value = flat[at:at + n].view(leaf.shape) * leaf.std + leaf.mean
            if leaf.name.startswith(tuple(self.non_negative)):
                value = value.abs()
            out[leaf.name] = value.to(leaf.dtype)
            at += n
        for name, value in self.set_leaves.items():
            out[name] = torch.full_like(out[name], value)
        return out


def load(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copies `state` into the module's parameters (its buffers stay)."""
    missing, unexpected = module.load_state_dict(state, strict=False)
    params = {n for n, _ in module.named_parameters()}
    if unexpected or params & set(missing):
        raise KeyError(f'state does not fit the module: missing '
                       f'{sorted(params & set(missing))[:5]}, unexpected '
                       f'{unexpected[:5]}')
