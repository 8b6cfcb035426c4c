"""Camera projections: the weak perspective (counterpart of
``human_pose_estimation_tpu/core/projection.py``), and the port's own
perspective projection from intrinsics (Multi-HMR's camera)."""
from __future__ import annotations

import torch

__all__ = ["orth_project", "perspective_project", "reproject_to_pixels"]


def orth_project(points: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """``s * (X[..., :2] + [tx, ty])`` per batch element.

    points (N, P, 3), camera (N, 3) as [scale, tx, ty] -> (N, P, 2) in the
    [-1, 1] image frame.
    """
    cam = camera.reshape(-1, 1, 3)
    return cam[..., :1] * (points[..., :2] + cam[..., 1:])


def perspective_project(points: torch.Tensor, translation: torch.Tensor, focal: float,
                        principal: float) -> torch.Tensor:
    """The pinhole camera at the origin looking down +z, with square
    pixels: ``f * (X + t)[:2] / (Z + tz) + c``.

    points (N, P, 3), translation (N, 3), ``focal`` and ``principal`` (the
    principal point, the same on both axes) in pixels -> (N, P, 2) pixel
    coordinates."""
    p = points + translation.reshape(-1, 1, 3)
    return focal * p[..., :2] / p[..., 2:] + principal


def reproject_to_pixels(verts: torch.Tensor, camera: torch.Tensor, img_size) -> torch.Tensor:
    """Project (N, V, 3) vertices and map [-1, 1] to pixel coordinates;
    ``img_size`` is a scalar or [h, w]."""
    projected = orth_project(verts, camera)
    if isinstance(img_size, (int, float)):
        # a Python scalar, not a tensor: copying a host value to the device
        # would make the host wait for the device in every training step
        return (projected + 1.0) * 0.5 * img_size
    size = torch.as_tensor(img_size, dtype=projected.dtype, device=projected.device)
    return (projected + 1.0) * 0.5 * size
