"""Keypoint evaluation metrics (counterpart of ``human_pose_estimation_tpu/
ops/metrics.py``): PCK with torso-diameter normalization, the PCK curve,
its area, and per-joint PCK — what the validation sweep reports."""
from __future__ import annotations

import torch

# LSP joint ids used for the torso-size reference length
_RIGHT_HIP = 2
_LEFT_SHOULDER = 9


def _torso(kp_gt: torch.Tensor) -> torch.Tensor:
    torso = torch.linalg.vector_norm(
        kp_gt[:, _LEFT_SHOULDER, :2] - kp_gt[:, _RIGHT_HIP, :2], dim=-1
    )
    return torso.clamp_min(1e-6)[:, None]


def _dist(kp_gt: torch.Tensor, kp_pred: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(kp_gt[..., :2] - kp_pred, dim=-1)


def pck(kp_gt: torch.Tensor, kp_pred: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """PCK@alpha: the fraction of visible keypoints within
    ``alpha * ||gt[l-shoulder] - gt[r-hip]||`` of the ground truth.
    kp_gt (N, K, 3) [x, y, vis], kp_pred (N, K, 2) -> scalar."""
    vis = kp_gt[..., 2]
    correct = (_dist(kp_gt, kp_pred) <= alpha * _torso(kp_gt)).float() * vis
    return correct.sum() / vis.sum().clamp_min(1.0)


def pck_curve(kp_gt, kp_pred, thresholds=(0.1, 0.2, 0.3, 0.4, 0.5)) -> torch.Tensor:
    """PCK at several torso-normalized thresholds -> (len(thresholds),)."""
    vis = kp_gt[..., 2]
    ndist = _dist(kp_gt, kp_pred) / _torso(kp_gt)  # (N, K)
    ts = torch.as_tensor(thresholds, dtype=torch.float32, device=kp_gt.device)
    correct = (ndist[None] <= ts[:, None, None]).float() * vis[None]
    return correct.sum(dim=(1, 2)) / vis.sum().clamp_min(1.0)


def pck_auc(kp_gt, kp_pred, max_threshold: float = 0.5, num: int = 20) -> torch.Tensor:
    """Area under the PCK curve over [0, max_threshold] (trapezoidal),
    normalized to [0, 1]."""
    ts = torch.linspace(0.0, max_threshold, num, device=kp_gt.device)
    curve = pck_curve(kp_gt, kp_pred, ts)
    return torch.trapezoid(curve, ts) / max_threshold


def per_joint_pck(kp_gt, kp_pred, alpha: float = 0.5) -> torch.Tensor:
    """PCK@alpha per joint -> (K,), 0 for never-visible joints."""
    vis = kp_gt[..., 2]
    correct = (_dist(kp_gt, kp_pred) <= alpha * _torso(kp_gt)).float() * vis
    return correct.sum(dim=0) / vis.sum(dim=0).clamp_min(1.0)
