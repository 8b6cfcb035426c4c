"""The plain vision transformer of HMR 2.0's and Multi-HMR's backbones: one
``ViT`` class, shaped by its widths (``ViTShape``) and its options
(``ViTOptions``), with two configurations.

* ViTPose-H (``VITPOSE``), HMR 2.0's backbone (Goel et al., ICCV 2023,
  arXiv:2305.20086; Xu et al., ViTPose, 2022), after ViTPose's ``ViT``
  (``hmr2/models/backbones/vit.py`` in github.com/shubham-goel/4D-Humans)
  and its parameter names: the input is a square crop (N, S, S, 3) in
  [-1, 1] of which the model sees the middle 3/4 of the columns (256 x 256
  -> 256 x 192, HMR 2.0's ``x[:, :, :, 32:-32]``); ``patch_embed.proj`` is
  Conv2d(3 -> width, kernel 16, stride 16, padding 2), 16 x 12 = 192
  tokens at 256 px; ``pos_embed`` (1, 1 + tokens, width) is added as
  ``pos[:, 1:] + pos[:, :1]`` (there is no class token); stochastic depth
  to 0.55.
* DINOv2's ViT-L/14 (``DINOV2``), Multi-HMR's backbone (Oquab et al.,
  2023; Baradel et al., ECCV 2024, arXiv:2402.14654): the whole square
  image, ``patch_embed.proj`` Conv2d(3 -> width, kernel 14, stride 14, no
  padding), 64 x 64 = 4096 patches at 896 px; a class token ``cls_token``
  (1, 1, width) before them; ``pos_embed`` (1, 1 + 37 * 37, width) stored
  on DINOv2's 37 x 37 grid, its patch part resized bicubically to the
  image's grid on every forward (``F.interpolate``, ``align_corners``
  False) and added to the patches, its first row added to the class
  token; LayerScale on both branches (``ls1.gamma``, ``ls2.gamma``: the
  branch times a learned per-channel scale); no stochastic depth.

Shared by both: ``blocks``, pre-LN blocks ``x += dp(ls(attn(LN(x))))``,
``x += dp(ls(mlp(LN(x))))`` (``ls`` the identity without LayerScale, ``dp``
without stochastic depth); attention with a biased qkv and an out
projection, ``F.scaled_dot_product_attention`` at scale 1 / sqrt(head
dim); the MLP width -> mlp, exact GELU, -> width; LayerNorm eps 1e-6;
``last_norm``, a final LayerNorm. The output is the (N, tokens, width)
token sequence (the class token first where there is one).

ViT-H/16: depth 32, width 1280, 16 heads of 80, MLP 5120, about 631M
parameters. ViT-L/14: depth 24, width 1024, 16 heads of 64, MLP 4096,
about 304M.

Stochastic depth (``dp``, train mode only): block i drops its two residual
branches at the rate ``linspace(0, drop_path_rate, depth)[i]`` (ViT-H's
0.55 in HMR 2.0), per sample:
a row is kept where ``floor(keep + u) == 1`` for one uniform u, and a kept
row is scaled by 1 / keep (timm's ``drop_path``: ``x / keep * mask``).
The masks are drawn before the forward, by ``ViT.draw_masks(n, generator)``,
and handed to it (``ViT.forward(images, masks)``), the contract of every
encoder of ``models/hmr.HMR``: one code path, eager or replayed from the
encoder's CUDA graph pair (``models/encoder_graph.py``), which copies them
into its capture's static buffer. The uniforms come from
the caller's ``torch.Generator`` in a fixed order: blocks in order, in each
the attention branch's (N,) then the MLP branch's (N,), f32 on the
generator's device, one ``torch.rand`` call each; a block at rate 0 draws
nothing (DINOv2's configuration draws nothing). Under a process group they
are drawn for the global batch and each rank keeps its rows
(``parallel.mesh.draw_rows``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as pmesh

PATCH, PATCH_PAD = 16, 2
LN_EPS = 1e-6
DROP_PATH_RATE = 0.55


class ViTShape(NamedTuple):
    depth: int
    width: int
    heads: int
    mlp: int


class ViTOptions(NamedTuple):
    patch: int  # the patch side, the convolution's kernel and stride
    patch_pad: int  # the convolution's padding
    crop_columns: bool  # see the middle 3/4 of the columns only
    class_token: bool  # a learned token before the patches
    layer_scale: Optional[float]  # LayerScale's initial scale; None for none
    pos_grid: Optional[int]  # the stored position grid's side (resized); None: the image's grid
    drop_path_rate: float  # stochastic depth's rate at the last block


VIT_H = ViTShape(depth=32, width=1280, heads=16, mlp=5120)
VIT_L = ViTShape(depth=24, width=1024, heads=16, mlp=4096)
VITPOSE = ViTOptions(PATCH, PATCH_PAD, True, False, None, None, DROP_PATH_RATE)
DINOV2 = ViTOptions(14, 0, False, True, 1e-5, 37, 0.0)


def crop_columns(img_size: int):
    """(first column, width) of the part of an ``img_size`` square crop that
    the ViT sees: the middle 3/4 of its columns."""
    width = img_size * 3 // 4
    return (img_size - width) // 2, width


def patch_grid(size: int, options: ViTOptions = VITPOSE) -> int:
    """The patches along a side of ``size`` pixels."""
    return (size + 2 * options.patch_pad - options.patch) // options.patch + 1


def drop_path(x: torch.Tensor, keep: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """timm's ``drop_path`` on (N, ...) rows with the (N,) 0 / 1 ``mask``
    of ``ViT.draw_masks``; ``x`` itself where ``mask`` is None."""
    if mask is None:
        return x
    return x / keep * mask.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


class PatchEmbed(nn.Module):
    def __init__(self, width: int, options: ViTOptions = VITPOSE):
        super().__init__()
        self.proj = nn.Conv2d(3, width, kernel_size=options.patch, stride=options.patch, padding=options.patch_pad)


class LayerScale(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c = x.shape
        q, k, v = self.qkv(x).reshape(n, t, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(n, t, c))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, shape: ViTShape, rate: float, layer_scale: bool = False):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.attn = Attention(shape.width, shape.heads)
        self.norm2 = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.mlp = Mlp(shape.width, shape.mlp)
        self.ls1 = LayerScale(shape.width) if layer_scale else nn.Identity()
        self.ls2 = LayerScale(shape.width) if layer_scale else nn.Identity()

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                mlp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        keep = 1.0 - self.rate
        x = x + drop_path(self.ls1(self.attn(self.norm1(x))), keep, attn_mask)
        return x + drop_path(self.ls2(self.mlp(self.norm2(x))), keep, mlp_mask)


class ViT(nn.Module):
    """The ViT on (N, S, S, 3) images -> (N, tokens, width): ViTPose's with
    the default options, DINOv2's with ``DINOV2``."""

    def __init__(self, img_size: int = 256, shape: ViTShape = VIT_H, options: ViTOptions = VITPOSE):
        super().__init__()
        self.shape, self.options = shape, options
        self.col0, cols = crop_columns(img_size) if options.crop_columns else (0, img_size)
        self.grid = (patch_grid(img_size, options), patch_grid(cols, options))
        self.num_tokens = self.grid[0] * self.grid[1]
        self.patch_embed = PatchEmbed(shape.width, options)
        stored = self.num_tokens if options.pos_grid is None else options.pos_grid**2
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + stored, shape.width))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, shape.width)) if options.class_token else None
        # ViTPose's rates: f32 linspace values (on the host, whatever the default device)
        rates = torch.linspace(0, options.drop_path_rate, shape.depth, device="cpu").tolist()
        self.blocks = nn.ModuleList([Block(shape, r, options.layer_scale is not None) for r in rates])
        self.last_norm = nn.LayerNorm(shape.width, eps=LN_EPS)

    @property
    def feature_dim(self) -> int:
        return self.shape.width

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """ViTPose's initialisation, drawn from ``generator`` on the module's
        device: dense weights truncated normal std 0.02 (timm's cut at +-2,
        which never binds), zero biases, LayerNorm 1 / 0, the position
        embedding as the dense weights; the patch convolution truncated
        LeCun normal (the encoders' convolution initialiser). DINOv2's
        besides: the class token normal std 1e-6, LayerScale at its
        initial scale."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerScale):
                nn.init.constant_(m.gamma, self.options.layer_scale)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-2.0, b=2.0, generator=generator)
        conv = self.patch_embed.proj
        patch = self.options.patch
        std = math.sqrt(1.0 / (3 * patch * patch)) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(conv.bias)
        if self.cls_token is not None:
            nn.init.normal_(self.cls_token, std=1e-6, generator=generator)

    def _patch_positions(self) -> torch.Tensor:
        """The stored patch positions on the image's grid, (1, tokens,
        width): resized bicubically where the grids differ."""
        pos = self.pos_embed[:, 1:]
        side = self.options.pos_grid
        if side is None or (side, side) == self.grid:
            return pos
        grid = pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=self.grid, mode="bicubic", align_corners=False)
        return grid.permute(0, 2, 3, 1).reshape(1, self.num_tokens, -1)

    def _dropping(self):
        """The blocks whose branches the train-mode forward drops, in order."""
        return [b for b in self.blocks if b.rate != 0.0] if self.training else []

    def draw_masks(self, n: int, generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The train-mode forward's stochastic-depth masks for ``n`` rows,
        drawn from ``generator`` in the order the module docstring gives:
        (2 x the blocks at a rate above 0, n) f32 0 / 1 on the generator's
        device, the attention branch's row then the MLP branch's, block by
        block. None in eval mode, or where no block drops."""
        blocks = self._dropping()
        if not blocks:
            return None
        if generator is None:
            raise ValueError("train-mode stochastic depth needs a torch.Generator")
        draw = lambda shape: torch.rand(shape, generator=generator, device=generator.device)  # noqa: E731
        return torch.stack([torch.floor((1.0 - b.rate) + pmesh.draw_rows(draw, (n,)))
                            for b in blocks for _branch in ("attn", "mlp")])

    def forward(self, images: torch.Tensor, masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (N, S, S, 3) in [-1, 1] -> tokens (N, tokens, width); in
        train mode ``masks`` are ``draw_masks(N, generator)``'s."""
        dropping = self._dropping()
        if dropping and (masks is None or masks.shape != (2 * len(dropping), images.shape[0])):
            raise ValueError("train-mode stochastic depth needs the masks of draw_masks(N, generator)")
        x = images[:, :, self.col0 : images.shape[2] - self.col0].permute(0, 3, 1, 2)
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        if self.cls_token is None:
            x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        else:
            cls = (self.cls_token + self.pos_embed[:, :1]).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x + self._patch_positions()], dim=1)
        row = 0
        for block in self.blocks:
            if dropping and block.rate != 0.0:
                x = block(x, masks[row], masks[row + 1])
                row += 2
            else:
                x = block(x)
        return self.last_norm(x)
