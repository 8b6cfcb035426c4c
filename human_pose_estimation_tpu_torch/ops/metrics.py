"""Evaluation metrics (counterpart of ``human_pose_estimation_tpu/ops/
metrics.py``): PCK with torso-diameter normalization, the PCK curve, its
area and per-joint PCK (what the validation sweep reports), the mean
per-joint error, and the Procrustes-aligned error of 3D point sets."""
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


def mean_per_joint_error(kp_gt: torch.Tensor, kp_pred: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean error over the visible keypoints (scalar)."""
    vis = kp_gt[..., 2]
    return (_dist(kp_gt, kp_pred) * vis).sum() / vis.sum().clamp_min(1.0)


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


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-sample similarity (Procrustes, with scale; Umeyama) alignment of
    pred (N, P, 3) onto gt (N, P, 3): ``min_{s,R,t} ||s R pred + t - gt||``.
    Returns the aligned predictions (N, P, 3). A reflection is never
    taken: when the best orthogonal map has det < 0 the smallest singular
    direction is flipped."""
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_g = gt.mean(dim=1, keepdim=True)
    pc = pred - mu_p
    gc = gt - mu_g
    cov = torch.einsum("npi,npj->nij", gc, pc)  # (N, 3, 3) cross-covariance
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)], dim=-1)
    r = torch.einsum("nij,nj,njk->nik", u, d, vt)  # gt <- pred
    var_p = (pc * pc).sum(dim=(1, 2))
    scale = (s * d).sum(dim=-1) / var_p.clamp_min(1e-12)
    return scale[:, None, None] * torch.einsum("nij,npj->npi", r, pc) + mu_g


def pa_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-point Euclidean error after Procrustes alignment -> (N,):
    PA-MPJPE for joints, PVE-PA for vertices."""
    return torch.linalg.vector_norm(procrustes_align(pred, gt) - gt, dim=-1).mean(dim=-1)
