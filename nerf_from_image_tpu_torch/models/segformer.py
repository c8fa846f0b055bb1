"""SegFormer (MiT-B5) backbone and its all-MLP decode head (PyTorch port of
`nerf_from_image_tpu/models/segformer.py`).

Overlap patch embeddings, efficient attention with spatial-reduction
ratios 8/4/2/1, Mix-FFN with a depthwise convolution, stochastic depth
(identity in eval), depths 3/6/40/3, widths 64/128/320/512, heads
1/2/5/8, and the fused 1/4-resolution decoder of width 768. Module names
are the reference state dict's (`patch_embed<i>.{proj,norm}`,
`block<i>.<j>.{norm1,attn.{q,kv,proj,sr,norm},norm2,mlp.{fc1,dwconv.dwconv,
fc2}}`, `norm<i>`, `linear_c<i>.proj`, `linear_fuse`, `linear_pred`),
the keys `nerf_from_image_tpu/utils/torch_convert.convert_segformer`
reads. Every LayerNorm takes flax's epsilon, 1e-6, as the JAX package
does. The attention is plain tensor algebra (float32 matmuls), as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Stochastic depth: each sample's residual kept with probability
    1 - rate and rescaled; the identity in eval."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                      device=x.device) < keep
    return x * mask.to(x.dtype) / keep


def _tokens_to_map(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H*W, C) row-major tokens -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], height, width)


def _map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


class SegDWConv(nn.Module):
    """3x3 depthwise convolution over the token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
        return _map_to_tokens(self.dwconv(_tokens_to_map(x, height, width)))


class SegMLP(nn.Module):
    """Mix-FFN: fc1 -> depthwise conv -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = SegDWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
        x = F.gelu(self.dwconv(self.fc1(x), height, width))
        return self.fc2(x)


class SegAttention(nn.Module):
    """Multi-head attention whose keys and values come from the token grid
    reduced by an sr x sr strided convolution (sr > 1)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q = self.q(x).reshape(b, n, self.num_heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_map_to_tokens(
                self.sr(_tokens_to_map(x, height, width))))
        m = kv_in.shape[1]
        kv = self.kv(kv_in).reshape(b, m, 2, self.num_heads, hd)
        k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
        out = torch.matmul(attn.softmax(dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SegBlock(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)), then
    x + mlp(norm2(x)), each residual under its own stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.0, sr_ratio: int = 1):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SegAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = SegMLP(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x), height, width),
                          self.drop_path_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x), height, width),
                             self.drop_path_rate, self.training)


class SegOverlapPatchEmbed(nn.Module):
    """Strided convolution with overlapping patches, then LayerNorm."""

    def __init__(self, patch_size: int, stride: int, in_channels: int,
                 embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=stride, padding=patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """(B, C, H, W) -> (tokens (B, h*w, D), h, w)."""
        x = self.proj(x)
        h, w = x.shape[2], x.shape[3]
        return self.norm(_map_to_tokens(x)), h, w


class Segformer(nn.Module):
    """MiT backbone + all-MLP decode head: (B, 3, H, W) -> (B, out, H/4,
    W/4), float32."""

    def __init__(self, out_features: int = 512,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 drop_path_rate: float = 0.1,
                 depths: Sequence[int] = (3, 6, 40, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 decoder_dim: int = 768):
        super().__init__()
        self.depths = tuple(depths)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur = 0
        in_ch = 3
        for i in range(4):
            setattr(self, f'patch_embed{i + 1}', SegOverlapPatchEmbed(
                7 if i == 0 else 3, 4 if i == 0 else 2, in_ch,
                embed_dims[i]))
            setattr(self, f'block{i + 1}', nn.ModuleList([
                SegBlock(embed_dims[i], num_heads[i], mlp_ratios[i],
                         rates[cur + j], sr_ratios[i])
                for j in range(depths[i])]))
            setattr(self, f'norm{i + 1}',
                    nn.LayerNorm(embed_dims[i], eps=LN_EPS))
            cur += depths[i]
            in_ch = embed_dims[i]
        for i in range(4):
            head = nn.Module()
            head.proj = nn.Linear(embed_dims[i], decoder_dim)
            setattr(self, f'linear_c{i + 1}', head)
        self.linear_fuse = nn.Conv2d(4 * decoder_dim, decoder_dim, 1)
        self.linear_pred = nn.Conv2d(decoder_dim, out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = []
        for i in range(1, 5):
            tokens, h, w = getattr(self, f'patch_embed{i}')(x)
            for block in getattr(self, f'block{i}'):
                tokens = block(tokens, h, w)
            tokens = getattr(self, f'norm{i}')(tokens)
            x = _tokens_to_map(tokens, h, w)
            features.append(x)

        out_h, out_w = features[0].shape[2], features[0].shape[3]
        maps = []
        for i in reversed(range(4)):
            f = features[i]
            c = getattr(self, f'linear_c{i + 1}').proj(_map_to_tokens(f))
            c = _tokens_to_map(c, f.shape[2], f.shape[3])
            if i > 0:
                c = F.interpolate(c, size=(out_h, out_w), mode='bilinear',
                                  align_corners=False)
            maps.append(c)
        fused = self.linear_fuse(torch.cat(maps, dim=1))
        return self.linear_pred(fused).float()
