"""ResNet v1 image encoder with the Keras layout, in PyTorch.

Counterpart of ``human_pose_estimation_tpu/models/resnet.py``; module and
parameter names follow the Flax tree (``conv1``, ``bn1``,
``stage{s}_block{b}/{conv,bn}{1,2,3,_sc}``) so the weight bridge
(models/port_jax.py) is a renaming. Keras details kept:

* classic v1 bottleneck: the stride sits on the FIRST 1x1 of each
  downsampling block;
* every conv has a bias;
* BatchNorm eps 1.001e-5 with Flax's train mode (``FlaxBatchNorm2d``):
  batch statistics with the biased ("fast") variance, and running
  statistics updated as ``0.99 * running + 0.01 * batch``;
* stem: zero pad 3 -> 7x7/2 conv -> BN/relu -> zero pad 1 -> 3x3/2 max
  pool. The pool's padding is -inf in torch and zero in Keras, which agree
  after the relu (every window holds a real value >= 0);
* global average pool head -> (N, 2048) in f32.

The public input is NHWC (N, H, W, 3), as in the JAX package; it is
permuted to NCHW inside.

``stem='s2d'`` is the JAX package's space-to-depth stem: an exact rewrite
of the 7x7/2 conv as a 4x4/1 conv over the 2x2 space-to-depth input
(``space_to_depth_2x2`` on NHWC, before the permute, so that the channel
order (dy, dx, c) is JAX's), with ``conv1`` held in the (64, 12, 4, 4)
layout that ``conv1_kernel_to_s2d`` / ``convert_params_to_s2d`` make from
standard weights. As in the JAX package, no config, CLI or ``HMR`` builds
it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import at_least_f32
from ..parallel import mesh as pmesh

BN_EPS = 1.001e-5
BN_MOMENTUM = 0.01  # torch convention: Flax/Keras momentum 0.99

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the train mode of Flax's ``nn.BatchNorm``.

    In train mode it normalises with the batch mean and the biased batch
    variance ``max(E[x^2] - E[x]^2, 0)``, both in f32 (Flax's fast
    variance), and updates the running buffers itself with that biased
    variance: ``running = (1 - momentum) * running + momentum * batch``.
    ``nn.BatchNorm2d`` would update the running variance with the unbiased
    one, off by N*H*W / (N*H*W - 1). Eval mode is ``nn.BatchNorm2d``'s.
    Parameter and buffer names are unchanged. Under a process group the
    moments are those of the global batch (``parallel/mesh.py``), so the
    running buffers agree on every rank and with one process over all the
    rows (``nn.SyncBatchNorm`` would update the running variance with the
    unbiased estimate, the same trap). With
    ``update_running_stats`` False the train mode leaves the buffers alone
    (the recompute of a rematerialised encoder, ``models/hmr.py``).
    """

    update_running_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = at_least_f32(x)  # statistics in at least f32, as Flax
        if pmesh.is_distributed():
            # the moments of the global batch: the mean over the ranks of
            # their per-channel E[x] and E[x^2] (equal counts), all-reduced
            # differentiably
            c = xf.shape[1]
            local = torch.cat([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
            moments = pmesh.global_sum(local) / pmesh.world_size()
            mean = moments[:c]
            var = (moments[c:] - mean * mean).clamp_min(0.0)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        if self.update_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(mean.detach(), alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(var.detach(), alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _bn(channels: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck; projection shortcut on the first
    block of each stage."""

    def __init__(self, in_ch: int, filters: int, stride: int, project: bool):
        super().__init__()
        self.project = project
        if project:
            self.conv_sc = nn.Conv2d(in_ch, filters * 4, 1, stride=stride)
            self.bn_sc = _bn(filters * 4)
        self.conv1 = nn.Conv2d(in_ch, filters, 1, stride=stride)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn2 = _bn(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1)
        self.bn3 = _bn(filters * 4)

    def forward(self, x):
        shortcut = self.bn_sc(self.conv_sc(x)) if self.project else x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + shortcut)


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C) with channel order (dy, dx, c);
    H and W must be even."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"the s2d stem needs an even height and width, got {h}x{w}")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def conv1_kernel_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Exact rewrite of the 7x7/2 stem kernel for a 2x2 space-to-depth
    input: OIHW (F, C, 7, 7) -> (F, 4C, 4, 4). The kernel is embedded in
    8x8 at offset 1; with the input padded (2, 1) per spatial axis, a 4x4/1
    conv with the result computes pad-3 + 7x7/2 on the raw image."""
    f, c = w7.shape[:2]
    w8 = w7.new_zeros((f, c, 8, 8))
    w8[:, :, 1:8, 1:8] = w7
    # w'[f, (dy, dx, cc), a, b] = w8[f, cc, 2a + dy, 2b + dx]
    w = w8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w.reshape(f, 4 * c, 4, 4)


class ResNet(nn.Module):
    """ResNet v1 backbone with an average-pool feature head. ``stem``:
    'standard' (7x7/2 conv) or 's2d' (its space-to-depth rewrite)."""

    def __init__(self, stage_sizes: Sequence[int] = STAGE_SIZES[50], stem: str = "standard"):
        super().__init__()
        if stem not in ("standard", "s2d"):
            raise ValueError(f"stem must be 'standard' or 's2d', got {stem!r}")
        self.stage_sizes = tuple(stage_sizes)
        self.stem = stem
        if stem == "s2d":
            self.conv1 = nn.Conv2d(12, 64, 4)
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = _bn(64)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        self.block_names = []
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = 64 * 2**stage
            for block in range(num_blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_block{block + 1}"
                self.add_module(name, Bottleneck(in_ch, filters, stride, project=block == 0))
                self.block_names.append(name)
                in_ch = filters * 4
        self.feature_dim = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) NHWC -> (N, feature_dim) f32."""
        if self.stem == "s2d":
            x = F.pad(space_to_depth_2x2(x).permute(0, 3, 1, 2), (2, 1, 2, 1))
        else:
            x = x.permute(0, 3, 1, 2)
        x = self.pool(torch.relu(self.bn1(self.conv1(x))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return at_least_f32(x.mean(dim=(2, 3)))


def ResNet50(stem: str = "standard") -> ResNet:
    return ResNet(STAGE_SIZES[50], stem=stem)


def make_resnet(depth: int = 50, stem: str = "standard") -> ResNet:
    """ResNet-{50,101,152} v1 encoder (Keras layout at every depth, so
    keras.applications weights port the same way: models/port_keras.py)."""
    if depth not in STAGE_SIZES:
        raise ValueError(f"encoder depth must be one of {sorted(STAGE_SIZES)}")
    return ResNet(STAGE_SIZES[depth], stem=stem)


def convert_params_to_s2d(state_dict):
    """A standard-stem ``ResNet`` state dict rewritten for ``stem='s2d'``: a
    new dict with ``conv1.weight`` through ``conv1_kernel_to_s2d``; every
    other entry is shared."""
    new = dict(state_dict)
    new["conv1.weight"] = conv1_kernel_to_s2d(new["conv1.weight"])
    return new
