"""IEF (iterative error feedback) SMPL-parameter regressor (counterpart of
``human_pose_estimation_tpu/models/regressor.py``): an MLP
(features + 85) -> 1024 -> dropout(.5) -> 1024 -> dropout(.5) -> 85
predicting a delta-Theta per IEF stage."""
from __future__ import annotations

import math

import torch
from torch import nn

THETA_DIM = 85  # [cam 3 | pose 72 | shape 10]
FEATURE_DIM = 2048
HIDDEN_DIM = 1024
DROPOUT_RATE = 0.5


class IEFRegressor(nn.Module):
    def __init__(self, feature_dim: int = FEATURE_DIM):
        """feature_dim: the encoder's output width (2048 for ResNet-50;
        shallow test encoders differ)."""
        super().__init__()
        self.fc1 = nn.Linear(feature_dim + THETA_DIM, HIDDEN_DIM)
        self.fc2 = nn.Linear(HIDDEN_DIM, HIDDEN_DIM)
        self.out = nn.Linear(HIDDEN_DIM, THETA_DIM)
        self.drop1 = nn.Dropout(DROPOUT_RATE)
        self.drop2 = nn.Dropout(DROPOUT_RATE)

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

    def forward(self, features: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """One IEF stage: concat(features, theta) -> delta theta (f32).
        Dropout acts only in train mode."""
        x = torch.cat([features, theta], dim=-1)
        x = self.drop1(torch.relu(self.fc1(x)))
        x = self.drop2(torch.relu(self.fc2(x)))
        return self.out(x).float()
