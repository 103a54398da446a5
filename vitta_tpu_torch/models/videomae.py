"""VideoMAE-style ViT-B for video.

The PyTorch counterpart of vitta_tpu/models/videomae.py (reference
models/videomae_models/modeling_finetune.py, reached through get_model's
'videomae' arch): a 3D patch embedding (2, 16, 16), a joint space-time
transformer encoder, a final LayerNorm, mean pooling and a linear head.
Every LayerNorm is tapped (``blocks_{i}.norm1``, ``blocks_{i}.norm2``,
``norm``: the JAX package's flattened names), so ViTTA's LayerNorm
statistics apply as they do to Video Swin.

On the card each LayerNorm is the port's LayerNorm kernel pair
(ops/cuda_ln.py) and each MLP the MLP kernels without the LayerNorm
(ops/cuda_mlp.py:mlp), as vitta_tpu runs ``pallas_ln`` and ``fused_mlp``
at these widths on the TPU.  The attention is plain ``torch.matmul`` and
softmax in float32, as vitta_tpu computes it outside any kernel.

Module names are timm's (``patch_embed.proj``, ``blocks.3.attn.qkv``,
``norm``, ``head``), so a reference state dict converted by
``utils/checkpoint.py:videomae_state_dict`` loads with ``strict=True``.
Float32 only: vitta_tpu's model zoo dispatch hands VideoMAE no dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from vitta_tpu_torch.models.layers import LayerNorm, conv_ndhwc
from vitta_tpu_torch.models.swin import Mlp, drop_path
from vitta_tpu_torch.ops.cuda_mlp import mlp


class ViTAttention(nn.Module):
    """qkv, softmax(q k^T / sqrt(hd)) v per head, proj
    (vitta_tpu/models/videomae.py:23-40): q is scaled before the product,
    as there."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd)
        q = qkv[:, :, 0].transpose(1, 2)                 # (b, nh, n, hd)
        k = qkv[:, :, 1].permute(0, 2, 3, 1)             # (b, nh, hd, n)
        v = qkv[:, :, 2].transpose(1, 2)
        attn = torch.softmax(torch.matmul(q * hd ** -0.5, k), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class ViTBlock(nn.Module):
    """Pre-norm transformer block (vitta_tpu/models/videomae.py:43-57)."""

    def __init__(self, dim: int, num_heads: int, tap_prefix: str,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, f"{tap_prefix}.norm1")
        self.attn = ViTAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, f"{tap_prefix}.norm2")
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, taps=None, *, train: bool = False, generator=None):
        y = self.attn(self.norm1(x, taps))
        x = x + drop_path(y, self.drop_path, train, generator)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        y = mlp(self.norm2(x, taps), fc1.weight, fc1.bias, fc2.weight,
                fc2.bias)
        return x + drop_path(y, self.drop_path, train, generator)


def sincos_positions(n: int, dim: int) -> np.ndarray:
    """The fixed sin-cos position table (n, dim) of
    vitta_tpu/models/videomae.py:60-67: sines then cosines, float32."""
    pos = np.arange(n)[:, None]
    omega = 1.0 / (10000 ** (np.arange(dim // 2) / (dim / 2.0)))
    out = pos * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(
        np.float32)


class PatchEmbed(nn.Module):
    """Conv3d patchify (timm's ``patch_embed.proj``), no norm."""

    def __init__(self, patch_size, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=patch_size,
                              stride=patch_size)


class VideoMAE(nn.Module):
    """(B, T, H, W, 3) -> (B, K); ViT-B by default."""

    def __init__(self, num_classes: int,
                 patch_size: Tuple[int, int, int] = (2, 16, 16),
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 drop_path_rate: float = 0.1):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(tuple(patch_size), embed_dim)
        dpr = np.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, f"blocks_{i}", drop_path=dpr[i])
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, "norm")
        self.head = nn.Linear(embed_dim, num_classes)
        nn.init.normal_(self.head.weight, std=0.02)
        nn.init.zeros_(self.head.bias)
        self._pos_cache = {}

    def _positions(self, n: int, device) -> torch.Tensor:
        """The position table on ``device``, made once per token count."""
        key = (n, str(device))
        if key not in self._pos_cache:
            self._pos_cache[key] = torch.from_numpy(
                sincos_positions(n, self.embed_dim)).to(device)
        return self._pos_cache[key]

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        """x: (B, T, H, W, 3) -> logits (B, K).  The two BatchNorm
        arguments are the engine's and mean nothing here."""
        x = conv_ndhwc(self.patch_embed.proj, x)          # (B, t, h, w, C)
        b = x.shape[0]
        x = x.reshape(b, -1, self.embed_dim)
        x = x + self._positions(x.shape[1], x.device)
        for blk in self.blocks:
            x = blk(x, taps, train=train, generator=generator)
        x = self.norm(x, taps)
        return self.head(torch.mean(x, dim=1))
