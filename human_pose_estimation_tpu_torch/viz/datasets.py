"""Dataset sanity visualizers (counterpart of
``human_pose_estimation_tpu/viz/datasets.py``): grids of image batches
with their keypoints and silhouette points, and renders of mocap SMPL
meshes from several yaw angles. Host only: matplotlib (Agg) is imported
inside the functions, and the meshes are posed with this package's
``core/smpl.py`` on the body model's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def show_image_batch(
    batch,  # GenBatch (tensors or arrays)
    n: Optional[int] = None,
    out_path: Optional[str] = None,
):
    """Grid of (image + keypoints, image + silhouette points) per example.
    Saves to ``out_path`` and returns it, or returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = _np(batch.images)
    kps = _np(batch.kp2d)
    pts = _np(batch.seg_points)
    mask = _np(batch.seg_mask)
    n = n or images.shape[0]
    size = images.shape[1]

    fig, axes = plt.subplots(n, 2, figsize=(6, 3 * n), squeeze=False)
    for i in range(n):
        img01 = np.clip((images[i] + 1) * 0.5, 0, 1)
        axes[i][0].imshow(img01)
        vis = kps[i, :, 2] > 0
        xs = (kps[i, vis, 0] + 1) * 0.5 * size
        ys = (kps[i, vis, 1] + 1) * 0.5 * size
        axes[i][0].scatter(xs, ys, c="r", s=8)
        axes[i][0].set_title("image + keypoints")
        axes[i][1].imshow(img01)
        m = mask[i] > 0
        axes[i][1].scatter(pts[i, m, 0], pts[i, m, 1], c="lime", s=1)
        axes[i][1].set_title("silhouette points")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    return fig


def posed_vertices(smpl, poses: np.ndarray, shapes: np.ndarray) -> np.ndarray:
    """(N, V, 3) f32 vertices of the mocap samples, pushed 2.5 in front of
    the camera: what ``draw_smpl_meshes`` renders."""
    from ..core.smpl import smpl_forward

    device = smpl.v_template.device
    with torch.no_grad():
        out = smpl_forward(
            smpl,
            torch.as_tensor(np.asarray(shapes, np.float32), device=device),
            torch.as_tensor(np.asarray(poses, np.float32), device=device),
        )
    return _np(out.verts) + np.array([0.0, 0.0, 2.5])


def draw_smpl_meshes(
    smpl,
    poses: np.ndarray,  # (N, 72)
    shapes: np.ndarray,  # (N, 10)
    angles: Sequence[float] = (0.0, 60.0, -60.0, 180.0),
    img_size: int = 256,
    out_path: Optional[str] = None,
):
    """Render the SMPL meshes of mocap samples from several yaw angles.
    Saves to ``out_path`` and returns it, or returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .renderer import SMPLRenderer

    verts = posed_vertices(smpl, poses, shapes)
    faces = smpl.faces if smpl.faces is not None else np.zeros((0, 3), np.int64)
    renderer = SMPLRenderer(img_size=img_size, faces=faces)

    n = verts.shape[0]
    fig, axes = plt.subplots(n, len(angles), figsize=(3 * len(angles), 3 * n), squeeze=False)
    for i in range(n):
        for j, ang in enumerate(angles):
            img = renderer.rotated(verts[i], ang, axis="y") if ang else renderer(verts[i])
            axes[i][j].imshow(img)
            axes[i][j].set_title(f"{ang:.0f}°")
            axes[i][j].axis("off")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    return fig
