"""The plain reference of the losses and metrics: the visibility-weighted
keypoint L1, the bidirectional silhouette chamfer (value, and a form that
autograd differentiates), the mesh-reprojection loss, the WGAN-GP penalty
and PCK.

The chamfer, per image over the squared distances ``d = |g - p|^2``
between silhouette pixels g (mask > 0) and projected vertices p: the sum
over pixels of ``|g - p|_1`` to the first L2-nearest vertex, plus the sum
over vertices of the distance to the nearest pixel; 0 for an empty mask.
Computed in chunks of pixels so that the distance field fits.
"""
from __future__ import annotations

from typing import Sequence

import torch

BIG = 1e30


def keypoint_loss(kp_gt, kp_pred):
    """Sum of visible |error| over 2 x the visible count. kp_gt (N, K, 3)
    [x, y, vis], kp_pred (N, K, 2)."""
    vis = kp_gt[..., 2:3]
    err = torch.where(vis > 0, (kp_gt[..., :2] - kp_pred).abs() * vis, torch.zeros_like(kp_pred))
    return err.sum() / (torch.count_nonzero(vis) * 2).clamp_min(1).to(err.dtype)


@torch.no_grad()
def _nearest(gt, mask, pred, chunk: int):
    """(index of each pixel's first nearest vertex (N, P), index of each
    vertex's first nearest valid pixel (N, V), that vertex's squared
    distance (N, V), BIG where no pixel is valid)."""
    n, p, _ = gt.shape
    v = pred.shape[1]
    near_v = torch.zeros(n, p, dtype=torch.long, device=gt.device)
    best = torch.full((n, v), BIG, dtype=gt.dtype, device=gt.device)
    best_i = torch.zeros(n, v, dtype=torch.long, device=gt.device)
    for s in range(0, p, chunk):
        g, m = gt[:, s : s + chunk], mask[:, s : s + chunk]
        dx = g[:, :, None, 0] - pred[:, None, :, 0]
        dy = g[:, :, None, 1] - pred[:, None, :, 1]
        d = dx * dx + dy * dy
        near_v[:, s : s + chunk] = d.argmin(dim=2)
        d = torch.where(m[:, :, None] > 0, d, torch.full_like(d, BIG))
        cmin, ci = d.min(dim=1)
        take = cmin < best  # strict: the first pixel keeps a tie
        best_i = torch.where(take, ci + s, best_i)
        best = torch.where(take, cmin, best)
    return near_v, best_i, best


def chamfer(gt, mask, pred, chunk: int = 1024):
    """(N,) chamfer values; differentiable in ``pred`` through the selected
    distances (the selections are constants)."""
    near_v, best_i, best = _nearest(gt, mask, pred, chunk)
    p_near = pred.gather(1, near_v[..., None].expand(-1, -1, 2))
    l1 = ((gt - p_near).abs().sum(-1) * mask).sum(-1)
    g_near = gt.gather(1, best_i[..., None].expand(-1, -1, 2))
    found = best < BIG / 2
    d2 = ((pred - g_near) ** 2).sum(-1)
    nz = found & (d2 > 0)
    l2 = torch.where(nz, torch.sqrt(torch.where(nz, d2, torch.ones_like(d2))), torch.zeros_like(d2)).sum(-1)
    has = mask.sum(-1) > 0
    return torch.where(has, l1 + l2, torch.zeros_like(l1))


def mesh_loss(gt, mask, pred_px):
    """The silhouette loss of a batch: each image's chamfer over (3 + V),
    summed (the reference implementation's normalisation)."""
    return (chamfer(gt, mask, pred_px) / (3.0 + pred_px.shape[1])).sum()


def to_pixels(verts, cam, img_size: float):
    cam = cam.reshape(-1, 1, 3)
    return (cam[..., :1] * (verts[..., :2] + cam[..., 1:]) + 1.0) * 0.5 * img_size


def gradient_penalty(grads: Sequence[torch.Tensor]):
    """Sum over the critic's inputs of (1 - |batch-mean gradient|)^2."""
    total = grads[0].new_zeros(())
    for g in grads:
        total = total + (1.0 - torch.linalg.vector_norm(g.mean(dim=0).reshape(-1))) ** 2
    return total


def pck(kp_gt, kp_pred, alpha: float = 0.5):
    """Share of visible keypoints within alpha x |l-shoulder - r-hip| of the
    ground truth."""
    torso = torch.linalg.vector_norm(kp_gt[:, 9, :2] - kp_gt[:, 2, :2], dim=-1).clamp_min(1e-6)[:, None]
    vis = kp_gt[..., 2]
    ok = (torch.linalg.vector_norm(kp_gt[..., :2] - kp_pred, dim=-1) <= alpha * torso).float() * vis
    return ok.sum() / vis.sum().clamp_min(1.0)
