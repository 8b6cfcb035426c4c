"""The plain vision transformer of ViTPose-H, HMR 2.0's backbone (Goel et al.,
ICCV 2023, arXiv:2305.20086; Xu et al., ViTPose, 2022).

The port's own module: the JAX package has no transformer. It follows
ViTPose's ``ViT`` (``hmr2/models/backbones/vit.py`` in
github.com/shubham-goel/4D-Humans) and its parameter names:

* the input is a square crop (N, S, S, 3) in [-1, 1]; the model sees its
  middle 3/4 of the columns (256 x 256 -> 256 x 192, HMR 2.0's
  ``x[:, :, :, 32:-32]``);
* ``patch_embed.proj``: Conv2d(3 -> width, kernel 16, stride 16, padding 2),
  16 x 12 = 192 tokens at 256 px;
* ``pos_embed``: (1, 1 + tokens, width), added as ``pos[:, 1:] + pos[:, :1]``
  (there is no class token);
* ``blocks``: pre-LN blocks ``x += dp(attn(LN(x)))``, ``x += dp(mlp(LN(x)))``;
  attention with a biased qkv and an out projection,
  ``F.scaled_dot_product_attention`` at scale 1 / sqrt(head dim); the MLP
  width -> mlp, exact GELU, -> width; LayerNorm eps 1e-6;
* ``last_norm``: a final LayerNorm. The output is the (N, tokens, width)
  token sequence that the transformer-decoder head attends to.

ViT-H/16: depth 32, width 1280, 16 heads of 80, MLP 5120, about 631M
parameters.

Stochastic depth (``dp``, train mode only): block i drops its two residual
branches at the rate ``linspace(0, 0.55, depth)[i]`` (ViT-H's
``drop_path_rate`` in HMR 2.0), per sample:
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
nothing. Under a process group they are drawn for the global batch and each
rank keeps its rows (``parallel.mesh.draw_rows``).
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


VIT_H = ViTShape(depth=32, width=1280, heads=16, mlp=5120)


def crop_columns(img_size: int):
    """(first column, width) of the part of an ``img_size`` square crop that
    the ViT sees: the middle 3/4 of its columns."""
    width = img_size * 3 // 4
    return (img_size - width) // 2, width


def drop_path(x: torch.Tensor, keep: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """timm's ``drop_path`` on (N, ...) rows with the (N,) 0 / 1 ``mask``
    of ``ViT.draw_masks``; ``x`` itself where ``mask`` is None."""
    if mask is None:
        return x
    return x / keep * mask.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


class PatchEmbed(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, kernel_size=PATCH, stride=PATCH, padding=PATCH_PAD)


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
    def __init__(self, shape: ViTShape, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.attn = Attention(shape.width, shape.heads)
        self.norm2 = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.mlp = Mlp(shape.width, shape.mlp)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                mlp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        keep = 1.0 - self.rate
        x = x + drop_path(self.attn(self.norm1(x)), keep, attn_mask)
        return x + drop_path(self.mlp(self.norm2(x)), keep, mlp_mask)


class ViT(nn.Module):
    """ViTPose's ViT on (N, S, S, 3) crops -> (N, tokens, width)."""

    def __init__(self, img_size: int = 256, shape: ViTShape = VIT_H):
        super().__init__()
        self.shape = shape
        self.col0, cols = crop_columns(img_size)
        self.num_tokens = (img_size // PATCH) * (cols // PATCH)
        self.patch_embed = PatchEmbed(shape.width)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.num_tokens, shape.width))
        # ViTPose's rates: f32 linspace values (on the host, whatever the default device)
        rates = torch.linspace(0, DROP_PATH_RATE, shape.depth, device="cpu").tolist()
        self.blocks = nn.ModuleList([Block(shape, r) for r in rates])
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
        LeCun normal (the encoders' convolution initialiser)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-2.0, b=2.0, generator=generator)
        conv = self.patch_embed.proj
        std = math.sqrt(1.0 / (3 * PATCH * PATCH)) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(conv.bias)

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
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        row = 0
        for block in self.blocks:
            if dropping and block.rate != 0.0:
                x = block(x, masks[row], masks[row + 1])
                row += 2
            else:
                x = block(x)
        return self.last_norm(x)
