"""Evaluation losses (counterpart of ``human_pose_estimation_tpu/ops/
losses.py``): the visibility-weighted keypoint L1 and the silhouette
mesh-reprojection (bidirectional chamfer) loss."""
from __future__ import annotations

import torch

from .cuda_chamfer import chamfer_forward, chamfer_forward_reference

__all__ = ["keypoint_reprojection_loss", "mesh_reprojection_loss"]


def keypoint_reprojection_loss(kp_gt: torch.Tensor, kp_pred: torch.Tensor) -> torch.Tensor:
    """Visibility-weighted L1 keypoint loss: the sum of visible |error|
    over 2 x (#visible keypoints) (``tf.losses.absolute_difference`` with
    SUM_BY_NONZERO_WEIGHTS).

    kp_gt (N, K, 3) [x, y, visibility], kp_pred (N, K, 2) -> scalar.
    """
    vis = kp_gt[..., 2:3]
    # where(), not a plain multiply: an invisible keypoint contributes an
    # exact 0 even when the prediction is non-finite (NaN * 0 = NaN would
    # poison the batch; padded eval batches can produce such predictions)
    err = torch.where(vis > 0, (kp_gt[..., :2] - kp_pred).abs() * vis, torch.zeros_like(kp_pred))
    num_present = torch.count_nonzero(vis) * 2
    denom = num_present.clamp_min(1).to(err.dtype)
    return err.sum() / denom


def mesh_reprojection_loss(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    scale_mode: str = "reference",
    impl: str = "auto",
) -> torch.Tensor:
    """Silhouette mesh-reprojection loss summed over the batch (scalar).

    ``scale_mode='reference'`` divides each image by 3 + V (the
    reference's silhouette_gt.shape[1] quirk); ``'count'`` by its true
    pixels + vertices.

    impl: 'auto' = ``chamfer_forward`` (the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors); 'reference' = the plain version on
    any device.
    """
    if impl == "auto":
        per_image = chamfer_forward(gt_points, gt_mask, pred_points)
    elif impl == "reference":
        per_image = chamfer_forward_reference(gt_points, gt_mask, pred_points)
    else:
        raise ValueError(f"unknown impl: {impl!r}")
    v = pred_points.shape[1]
    if scale_mode == "reference":
        denom = 3.0 + v
    elif scale_mode == "count":
        denom = gt_mask.float().sum(dim=-1) + v
    else:
        raise ValueError(f"unknown scale_mode: {scale_mode!r}")
    return (per_image / denom).sum()
