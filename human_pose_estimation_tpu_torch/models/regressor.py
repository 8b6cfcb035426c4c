"""IEF (iterative error feedback) SMPL-parameter regressor (counterpart of
``human_pose_estimation_tpu/models/regressor.py``): an MLP
(features + 85) -> 1024 -> dropout(.5) -> 1024 -> dropout(.5) -> 85
predicting a delta-Theta per IEF stage. Dropout acts only when the caller
passes ``train=True`` (Flax's ``__call__(..., train)``), with a mask drawn
from the caller's ``torch.Generator``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import at_least_f32
from ..core.projection import orth_project
from ..parallel import mesh as pmesh
from ..utils.tracing import span

THETA_DIM = 85  # [cam 3 | pose 72 | shape 10]
FEATURE_DIM = 2048
HIDDEN_DIM = 1024
DROPOUT_RATE = 0.5


class IEFRegressor(nn.Module):
    takes_slots = False  # its rows are the images (``HMR.forward``'s ``slots``)

    def __init__(self, feature_dim: int = FEATURE_DIM, dropout_rate: float = DROPOUT_RATE):
        """feature_dim: the encoder's output width (2048 for ResNet-50;
        shallow test encoders differ)."""
        super().__init__()
        self.fc1 = nn.Linear(feature_dim + THETA_DIM, HIDDEN_DIM)
        self.fc2 = nn.Linear(HIDDEN_DIM, HIDDEN_DIM)
        self.out = nn.Linear(HIDDEN_DIM, THETA_DIM)
        self.dropout_rate = dropout_rate

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: glorot-uniform hidden layers,
        the reference's tiny uniform on the output layer
        (limit = sqrt(3 * 0.02 / (hidden + out))), zero biases."""
        for fc in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(fc.weight, generator=generator)
            nn.init.zeros_(fc.bias)
        limit = math.sqrt(3.0 * 0.02 / (HIDDEN_DIM + THETA_DIM))
        nn.init.uniform_(self.out.weight, -limit, limit, generator=generator)
        nn.init.zeros_(self.out.bias)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Flax's ``nn.Dropout``: keep with probability 1 - rate, scale the
        kept values by 1 / (1 - rate); rate 0 returns the input."""
        if self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        keep_prob = 1.0 - self.dropout_rate
        # drawn for the global batch under a process group, this rank's rows kept
        draw = lambda shape: torch.rand(shape, generator=generator, device=x.device)  # noqa: E731
        keep = pmesh.draw_rows(draw, x.shape) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(
        self,
        features: torch.Tensor,
        theta: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One IEF stage: concat(features, theta) -> delta theta (f32).
        With ``train`` dropout acts after the fc1 and fc2 ReLUs, drawing its
        masks from ``generator`` (on the tensors' device)."""
        x = torch.cat([features, theta], dim=-1)
        x = torch.relu(self.fc1(x))
        if train:
            x = self._dropout(x, generator)
        x = torch.relu(self.fc2(x))
        if train:
            x = self._dropout(x, generator)
        return at_least_f32(self.out(x))

    def initial(self, mean_theta: torch.Tensor, n: int) -> torch.Tensor:
        """The first estimate: the (1, 85) mean theta on each of ``n`` rows."""
        return mean_theta.expand(n, -1)

    project = staticmethod(orth_project)

    def step(self, features, theta, first, last, generator, autocast, slots=None):
        """One IEF stage from ``theta`` (the mean theta on the ``first``):
        (the next theta, the stage's theta, cam, pose and shape, the body
        model's pose). Train-mode dropout acts on the ``last`` stage only
        (the reference quirk); ``autocast()`` covers the MLP. The regressor
        takes no person slots."""
        from .hmr import split_theta  # the theta layout, where the JAX package keeps it

        if first:
            theta = self.initial(theta, features.shape[0])
        with span("model.ief"), autocast():
            delta = self(features, theta, train=self.training and last, generator=generator)
        theta = theta + delta
        cam, pose, shape = split_theta(theta)
        return theta, dict(theta=theta, cam=cam, pose=pose, shape=shape), {"theta": pose}
