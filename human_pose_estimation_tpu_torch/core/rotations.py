"""Rotation math for the SMPL body model, in PyTorch.

Counterpart of ``human_pose_estimation_tpu/core/rotations.py`` (``skew``,
``rodrigues``, ``lrotmin`` and ``rotation_distance``). The Rodrigues angle
keeps the reference's ``norm(theta + 1e-8)`` quirk — the epsilon is added
to each component before the norm — the JAX package's
``eps_mode='reference'``, the only mode its body model uses.

``rot6d_to_rotmat`` and ``rotmat_to_rot6d`` are the port's own: the
continuous 6D rotation representation of Zhou et al. (CVPR 2019) in the
layout of HMR 2.0's ``rot6d_to_rotmat``, which the transformer-decoder
head regresses.
"""
from __future__ import annotations

import torch

__all__ = ["skew", "rodrigues", "lrotmin", "rotation_distance", "rot6d_to_rotmat", "rotmat_to_rot6d"]


def skew(vec: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices:
    ``skew(v) @ u == cross(v, u)``."""
    x, y, z = vec.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with the
    angle computed as ``norm(theta + 1e-8)``."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    axis = theta / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    outer = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return cos * eye + (1.0 - cos) * outer + sin * skew(axis)


def lrotmin(theta: torch.Tensor) -> torch.Tensor:
    """The pose-blendshape feature: (N, 72) axis-angle pose (root first)
    -> (N, 207) flattened ``R_k - I`` of the 23 non-root joints (SMPL
    eq. 9)."""
    body = theta[..., 3:].reshape(*theta.shape[:-1], 23, 3)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return (rodrigues(body) - eye).reshape(*theta.shape[:-1], 207)


def rotation_distance(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3) -> (...)."""
    rel = torch.einsum("...ij,...kj->...ik", r1, r2)
    trace = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotations (..., 6) -> rotation matrices (..., 3, 3), as HMR 2.0's
    ``rot6d_to_rotmat``: the six numbers read as two rows of (2, 3) and
    transposed into the columns a1, a2; Gram-Schmidt gives b1 = a1 / |a1|,
    b2 = the unit part of a2 orthogonal to b1, and b3 = b1 x b2 (norms
    clamped at 1e-12, ``F.normalize``'s eps)."""
    a = x.reshape(*x.shape[:-1], 2, 3)
    a1, a2 = a[..., 0, :], a[..., 1, :]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> their 6D form (..., 6): the first
    two columns, one after the other (``rot6d_to_rotmat``'s inverse on
    rotations)."""
    return r[..., :, :2].transpose(-1, -2).reshape(*r.shape[:-2], 6)
