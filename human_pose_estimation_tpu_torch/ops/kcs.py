"""Kinematic Chain Space (KCS) representation for the critic (counterpart
of ``human_pose_estimation_tpu/ops/kcs.py``).

Skeleton topology (14 LSP joints -> 13 bones):
  joints: 0 r-foot, 1 r-knee, 2 r-hip, 3 l-hip, 4 l-knee, 5 l-foot,
          6 r-wrist, 7 r-elbow, 8 r-shoulder, 9 l-shoulder, 10 l-elbow,
          11 l-wrist, 12 neck, 13 head.
"""
from __future__ import annotations

import numpy as np
import torch

NUM_KCS_JOINTS = 14
NUM_BONES = 13

# bone b connects joint b (+1) to _BONE_FAR_JOINT[b] (-1)
_BONE_FAR_JOINT = (1, 2, 8, 9, 3, 4, 7, 8, 12, 12, 9, 10, 13)


def bone_incidence_matrix(num_joints: int = NUM_KCS_JOINTS) -> np.ndarray:
    """The (14, 13) C matrix mapping joints to directed bones."""
    if num_joints != NUM_KCS_JOINTS:
        raise ValueError("only the 14-joint LSP skeleton is supported")
    c = np.zeros((num_joints, NUM_BONES), dtype=np.float32)
    c[np.arange(NUM_BONES), np.arange(NUM_BONES)] = 1.0
    c[np.asarray(_BONE_FAR_JOINT), np.arange(NUM_BONES)] = -1.0
    return c


def _bones(joints: torch.Tensor, c_matrix: torch.Tensor) -> torch.Tensor:
    j = joints[:, :NUM_KCS_JOINTS, :]
    return torch.einsum("nkc,kb->nbc", j, c_matrix.to(j.dtype))  # (N, 13, 3) bone vectors


def kcs(joints: torch.Tensor, c_matrix: torch.Tensor) -> torch.Tensor:
    """KCS = B^T B with B = J^T C: joints (N, >=14, 3) (the first 14 are
    used), c_matrix (14, 13) -> (N, 13, 13)."""
    b = _bones(joints, c_matrix)
    return b @ b.transpose(1, 2)


def bone_lengths_sq(joints: torch.Tensor, c_matrix: torch.Tensor) -> torch.Tensor:
    """Squared bone lengths (the KCS diagonal), (N, 13)."""
    b = _bones(joints, c_matrix)
    return (b * b).sum(dim=-1)
