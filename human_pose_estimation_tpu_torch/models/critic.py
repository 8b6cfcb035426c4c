"""RepNet-style KCS critic for the adversarial pose/shape prior
(counterpart of ``human_pose_estimation_tpu/models/critic.py``): three
streams scoring (KCS matrix + joints), shapes and joint rotations, giving
(N, 3) scores. Leaky-relu slope 0.2. Inputs are flattened row-major, as
in the Flax module."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import at_least_f32
from ..ops.kcs import NUM_BONES, NUM_KCS_JOINTS

LEAKY_SLOPE = 0.2


class Critic(nn.Module):
    def __init__(self):
        super().__init__()
        self.kcs_dense = nn.Linear(NUM_BONES * NUM_BONES, 100)
        self.joints_dense = nn.Linear(NUM_KCS_JOINTS * 3, 100)
        self.combined_dense = nn.Linear(200, 1)
        self.shapes_dense_1 = nn.Linear(10, 10)
        self.shapes_dense_2 = nn.Linear(10, 5)
        self.shapes_dense_3 = nn.Linear(5, 1)
        self.rotation_dense_1 = nn.Linear(23 * 9, 300)
        self.rotation_dense_2 = nn.Linear(300, 100)
        self.rotation_dense_3 = nn.Linear(100, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform weights and zero biases, as the Flax critic."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, kcs, joints, shapes, rotations):
        """kcs (N, 13, 13), joints (N, 14, 3), shapes (N, 10), rotations
        (N, 23, 3, 3) without the root -> (N, 3) [skeleton, shape, rotation]."""
        n = kcs.shape[0]
        lrelu = lambda x: F.leaky_relu(x, LEAKY_SLOPE)
        kcs_h = lrelu(self.kcs_dense(kcs.reshape(n, -1)))
        joints_h = lrelu(self.joints_dense(joints.reshape(n, -1)))
        skel = self.combined_dense(torch.cat([kcs_h, joints_h], dim=-1))

        s = torch.relu(self.shapes_dense_1(shapes))
        s = torch.relu(self.shapes_dense_2(s))
        shape = self.shapes_dense_3(s)

        r = lrelu(self.rotation_dense_1(rotations.reshape(n, -1)))
        r = lrelu(self.rotation_dense_2(r))
        rot = self.rotation_dense_3(r)
        return at_least_f32(torch.cat([skel, shape, rot], dim=-1))
