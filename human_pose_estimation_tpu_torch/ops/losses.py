"""Training and evaluation losses (counterpart of ``human_pose_estimation_tpu/
ops/losses.py``): the visibility-weighted keypoint L1, the silhouette
mesh-reprojection (bidirectional chamfer) loss, the expanded-form
``chamfer_loss`` and the WGAN gradient penalty."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..parallel import mesh as pmesh
from .cuda_chamfer import chamfer, chamfer_forward_reference

__all__ = [
    "chamfer_loss",
    "gradient_penalty",
    "keypoint_reprojection_loss",
    "masked_mean",
    "mesh_reprojection_loss",
]


def keypoint_reprojection_loss(kp_gt: torch.Tensor, kp_pred: torch.Tensor) -> torch.Tensor:
    """Visibility-weighted L1 keypoint loss: the sum of visible |error|
    over 2 x (#visible keypoints) (``tf.losses.absolute_difference`` with
    SUM_BY_NONZERO_WEIGHTS). Under a process group the count is the global
    batch's, and the value this rank's share of the global loss.

    kp_gt (N, K, 3) [x, y, visibility], kp_pred (N, K, 2) -> scalar.
    """
    vis = kp_gt[..., 2:3]
    # where(), not a plain multiply: an invisible keypoint contributes an
    # exact 0 even when the prediction is non-finite (NaN * 0 = NaN would
    # poison the batch; padded eval batches can produce such predictions)
    err = torch.where(vis > 0, (kp_gt[..., :2] - kp_pred).abs() * vis, torch.zeros_like(kp_pred))
    num_present = torch.count_nonzero(vis) * 2
    if pmesh.is_distributed():  # the global batch's count: this rank's share of the loss
        num_present = pmesh.global_sum(num_present.to(err.dtype))
    denom = num_present.clamp_min(1).to(err.dtype)
    return err.sum() / denom


def chamfer_loss(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    chunk_size: int = 1024,
) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances in the JAX
    package's XLA form (``ops/losses.py:chamfer_loss``), differentiable by
    autograd.

    Distances in the expanded form ``|g|^2 - 2 g.p + |p|^2`` in full f32,
    chunked over pixels; first-index ties in both directions (a strict
    ``<`` across chunks); gt->pred takes ``|g - p|_1`` at the nearest
    vertex, pred->gt the exact norm to the nearest pixel's coordinates,
    with the double-where that keeps the gradient of ``sqrt(0)`` finite.
    The gradient flows through the selected distances, not the selections.
    """
    dtype = gt_points.dtype
    n, p, _ = gt_points.shape
    v = pred_points.shape[1]
    big = torch.finfo(dtype).max
    dev = gt_points.device
    pred_sq = (pred_points * pred_points).sum(dim=-1)  # (N, V)
    l1_acc = torch.zeros(n, dtype=dtype, device=dev)
    best_sq = torch.full((n, v), big, dtype=dtype, device=dev)
    best_xy = torch.zeros(n, v, 2, dtype=dtype, device=dev)
    for s in range(0, p, chunk_size):
        pts = gt_points[:, s : s + chunk_size]
        mask = gt_mask[:, s : s + chunk_size]
        cross = torch.einsum("ncx,nvx->ncv", pts, pred_points)
        d = (pts * pts).sum(dim=-1)[..., None] - 2.0 * cross + pred_sq[:, None, :]
        d = d.detach()  # selections only
        # gt -> pred: L1 to the first L2-nearest vertex, masked
        near = d.argmin(dim=-1, keepdim=True)  # (N, C, 1)
        p_near = pred_points.gather(1, near.expand(-1, -1, 2))  # (N, C, 2)
        diff = pts - p_near
        # |x| with JAX's derivative at 0 (+1; torch's abs gives 0 there)
        l1 = torch.where(diff >= 0, diff, -diff).sum(dim=-1) * mask
        l1_acc = l1_acc + l1.sum(dim=-1)
        # pred -> gt: running min over masked pixels, first pixel on ties
        d_masked = torch.where(mask[..., None] > 0, d, torch.full_like(d, big))
        row = d_masked.argmin(dim=1)  # (N, V)
        chunk_min = d_masked.gather(1, row[:, None, :])[:, 0]
        chunk_xy = pts.gather(1, row[..., None].expand(-1, -1, 2))
        take = chunk_min < best_sq
        best_xy = torch.where(take[..., None], chunk_xy, best_xy)
        best_sq = torch.where(take, chunk_min, best_sq)
    has_gt = gt_mask.sum(dim=-1) > 0
    d2 = ((pred_points - best_xy) ** 2).sum(dim=-1)
    nz = d2 > 0
    l2 = torch.where(nz, torch.sqrt(torch.where(nz, d2, torch.ones_like(d2))), torch.zeros_like(d2))
    zero = torch.zeros_like(l1_acc)
    return torch.where(has_gt, l2.sum(dim=-1), zero) + torch.where(has_gt, l1_acc, zero)


def mesh_reprojection_loss(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    scale_mode: str = "reference",
    impl: str = "auto",
) -> torch.Tensor:
    """Silhouette mesh-reprojection loss summed over the batch (scalar;
    under a process group, this rank's rows: its share of the global sum).

    ``scale_mode='reference'`` divides each image by 3 + V (the
    reference's silhouette_gt.shape[1] quirk); ``'count'`` by its true
    pixels + vertices.

    impl: 'auto' = ``cuda_chamfer.chamfer``, differentiable (K2 when a
    gradient is needed, K1 otherwise, on CUDA tensors; the plain versions
    on CPU tensors); 'reference' = the plain value-only version on any
    device; 'xla' = ``chamfer_loss``, the JAX package's expanded form
    under autograd.
    """
    if impl == "auto":
        per_image = chamfer(gt_points, gt_mask, pred_points)
    elif impl == "reference":
        per_image = chamfer_forward_reference(gt_points, gt_mask, pred_points)
    elif impl == "xla":
        per_image = chamfer_loss(gt_points, gt_mask, pred_points)
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


def masked_mean(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The mean over the rows of ``x`` (R, ...) whose weight in ``rows``
    (R,) is 1 (the valid person slots): the others count as 0 whatever they
    hold, and the count is at least 1."""
    keep = (rows > 0).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(keep, x, torch.zeros_like(x)).sum(0) / rows.sum().clamp_min(1.0)


def gradient_penalty(grads: Sequence[torch.Tensor], mode: str = "reference",
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP penalty over the critic's input gradients.

    ``mode='reference'``: the norm of the batch-mean gradient per input,
    ``(1 - norm)^2``, summed over the inputs (the reference's formulation);
    with ``rows`` (R,) the mean is over the rows of weight 1 (the valid
    person slots: the others count as 0), in one process.
    ``mode='per_sample'``: the paper's per-sample norm over all inputs
    jointly, ``mean((1 - sqrt(sq + 1e-12))^2)``.

    Under a process group the value is this rank's share of the global
    batch's penalty (the shares add up to it). The reference mode's norm is
    not linear in the rows: the mean gradient is all-reduced inside the
    graph (the double backward runs through that all-reduce), every rank
    computes the whole penalty, and its share is the penalty over the
    world size.
    """
    if mode == "reference":
        total = torch.zeros((), dtype=grads[0].dtype, device=grads[0].device)
        for g in grads:
            mean_g = g.mean(dim=0) if rows is None else masked_mean(g, rows)
            if pmesh.is_distributed():  # the global batch's mean: equal counts per rank
                mean_g = pmesh.global_sum(mean_g) / pmesh.world_size()
            total = total + (1.0 - torch.linalg.vector_norm(mean_g.reshape(-1))) ** 2
        return total / pmesh.world_size() if pmesh.is_distributed() else total
    if mode == "per_sample":
        if rows is not None:
            raise NotImplementedError("the per-sample penalty weighs every row")
        n = grads[0].shape[0]
        sq = torch.zeros(n, dtype=grads[0].dtype, device=grads[0].device)
        for g in grads:
            sq = sq + (g.reshape(n, -1) ** 2).sum(dim=-1)
        norms = torch.sqrt(sq + 1e-12)
        return pmesh.mean_share((1.0 - norms) ** 2)
    raise ValueError(f"unknown mode: {mode!r}")
