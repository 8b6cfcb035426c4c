"""The model's operations, counted from a configuration's widths alone, so
that the count depends on no implementation.

A multiply-add is two operations. Counted: every convolution and dense
layer of the ResNet encoder at the configured image size, the IEF
regressor's three dense layers per stage, and per body-model call the
shape and pose blend-shape products, the joint regression, the skinning
blend and transform, and the keypoint regression. Not counted: pooling,
BatchNorm, activations, Rodrigues and the kinematic chain (a few hundred
operations each), the losses, the critic (under 0.2 MFLOP a sample) and
the silhouette chamfer (the kernels' own roofline counts it). Training is
three times the forward (the forward, the gradient of the activations and
the gradient of the weights); nothing recomputed is counted.
"""
from __future__ import annotations

from typing import Sequence

THETA_DIM = 85


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet_macs(stage_sizes: Sequence[int], img: int) -> int:
    """Multiply-adds of the encoder's convolutions for one image (biases
    left out)."""
    macs = 0
    s = _out(img, 7, 2, 3)
    macs += s * s * 7 * 7 * 3 * 64
    s = _out(s, 3, 2, 1)  # max pool
    cin = 64
    for stage, blocks in enumerate(stage_sizes):
        f = 64 * 2**stage
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            so = _out(s, 1, stride, 0)
            if b == 0:
                macs += so * so * cin * 4 * f  # projection shortcut
            macs += so * so * cin * f  # 1x1 (carries the stride)
            macs += so * so * 9 * f * f  # 3x3
            macs += so * so * f * 4 * f  # 1x1 expand
            s, cin = so, 4 * f
    return macs


def ief_macs(feature_dim: int, hidden: int, num_stage: int) -> int:
    per_stage = (feature_dim + THETA_DIM) * hidden + hidden * hidden + hidden * THETA_DIM
    return num_stage * per_stage


def smpl_macs(num_verts: int, num_betas: int, num_joints: int, pose_features: int, keypoints: int) -> int:
    v3 = 3 * num_verts
    return (
        num_betas * v3  # shape blend shapes
        + num_verts * num_joints * 3  # rest joints
        + pose_features * v3  # pose blend shapes
        + num_verts * num_joints * 12  # blend the per-joint (R | t)
        + num_verts * 9  # apply the blended rotation
        + num_verts * keypoints * 3  # keypoint regression
    )


def forward_flops(cfg: dict, smpl_calls: int) -> float:
    """Operations of one image's forward: encoder, every IEF stage and
    ``smpl_calls`` body-model calls."""
    stage_sizes = cfg["encoder_stage_sizes"]
    feat = 64 * 2 ** (len(stage_sizes) - 1) * 4
    macs = (
        resnet_macs(stage_sizes, cfg["img_size"])
        + ief_macs(feat, cfg["ief_hidden"], cfg["num_stage"])
        + smpl_calls * smpl_macs(cfg["num_verts"], cfg["num_betas"], 24, 207, cfg["num_keypoints"])
    )
    return 2.0 * macs


def train_flops(cfg: dict) -> float:
    """One training image: three times the forward with the body model on
    every stage."""
    return 3.0 * forward_flops(cfg, cfg["num_stage"])
