"""Closed-loop synthetic ground-truth datasets.

The reference's headline capability is a training recipe whose quality is
only measurable against licensed assets (LSP/UP/MoSh + the SMPL body
model — ref report.pdf Tables 1-2, eval at src/trainer.py:992-995). This
module closes the loop hermetically: ground truth is generated FROM the
(synthetic) body model itself —

    sample (theta, beta, cam) -> SMPL forward -> render RGB + silhouette
    -> project keypoints -> write reference-schema records

— so training the full hybrid recipe (keypoint + mesh-reprojection +
critic losses) against these records and evaluating PCK / vertex error
tests the *capability* ("this recipe recovers pose"), not just per-op
parity.

The port's copy of ``human_pose_estimation_tpu/data/synthetic.py``: the
sampling and the rendering are the same numpy (and C++ rasterizer) code,
the body-model forward is the port's ``core/smpl.smpl_forward`` on
``device``. ``render_split`` returns a split's examples and generating
parameters in memory without writing them (a host without OpenCV, which
encodes the images, can still train on them);
``generate_closed_loop_dataset`` writes the same files as the JAX
function. OpenCV and TensorFlow are imported only where a split is
written (``_write_split``).

Rendering uses a long focal length (f=50) so the rasterized silhouette
closely matches the weak-perspective projection the losses use
(perspective error ~ z_extent * s / f ~ 1%); keypoint labels use exactly
the loss's weak-perspective math (core/projection.py).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.smpl import SMPLModel, smpl_forward
from ..viz.renderer import rasterize_mesh

# Per-joint axis-angle std-dev for pose sampling (24 SMPL joints): a
# plausible articulation range — limbs move a lot, spine a little.
_POSE_SIGMA = np.zeros(24)
_POSE_SIGMA[[1, 2]] = 0.30  # hips
_POSE_SIGMA[[4, 5]] = 0.40  # knees
_POSE_SIGMA[[7, 8]] = 0.20  # ankles
_POSE_SIGMA[[10, 11]] = 0.10  # feet
_POSE_SIGMA[[3, 6, 9]] = 0.10  # spine
_POSE_SIGMA[12] = 0.15  # neck
_POSE_SIGMA[15] = 0.20  # head
_POSE_SIGMA[[13, 14]] = 0.05  # collars
_POSE_SIGMA[[16, 17]] = 0.40  # shoulders
_POSE_SIGMA[[18, 19]] = 0.50  # elbows
_POSE_SIGMA[[20, 21]] = 0.20  # wrists
_POSE_SIGMA[[22, 23]] = 0.10  # hands

_RENDER_F = 50.0  # long focal: near-orthographic, matches weak perspective


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def axis_angle_from_matrix(r: np.ndarray) -> np.ndarray:
    """Log map SO(3) -> axis-angle (single matrix)."""
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-8:
        return np.zeros(3)
    if np.pi - angle < 1e-6:  # near-pi: use the symmetric part
        m = (r + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(m), 0.0))
        # fix signs from off-diagonals
        if m[0, 1] < 0:
            axis[1] = -axis[1]
        if m[0, 2] < 0:
            axis[2] = -axis[2]
        if axis[0] < axis[1] and m[1, 2] < 0:  # degenerate guard
            axis[2] = -abs(axis[2])
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        return axis * angle
    axis = (
        np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        / (2.0 * np.sin(angle))
    )
    return axis * angle


def sample_poses(
    rng: np.random.RandomState,
    n: int,
    yaw_range: float = 0.8,
    sigma_scale: float = 1.0,
) -> np.ndarray:
    """(n, 72) axis-angle poses: upright global orientation (the mean-
    params convention: pi about x maps the y-up body frame to image
    coords, ref load_mean_param src/trainer.py:201-223) with random yaw/
    roll, plus per-joint articulation noise."""
    pose = rng.randn(n, 24, 3) * (_POSE_SIGMA[None, :, None] * sigma_scale)
    pose = np.clip(pose, -1.2, 1.2)
    for i in range(n):
        yaw = rng.uniform(-yaw_range, yaw_range)
        roll = rng.randn() * 0.1
        r = _rot_x(np.pi) @ _rot_y(yaw) @ _rot_z(roll)
        pose[i, 0] = axis_angle_from_matrix(r)
    return pose.reshape(n, 72).astype(np.float32)


def sample_betas(rng: np.random.RandomState, n: int, scale: float = 0.7) -> np.ndarray:
    return np.clip(rng.randn(n, 10) * scale, -2.0, 2.0).astype(np.float32)


def sample_cams(
    rng: np.random.RandomState,
    n: int,
    s_range: Tuple[float, float] = (0.55, 0.9),
    t_max: float = 0.08,
) -> np.ndarray:
    s = rng.uniform(*s_range, size=n)
    t = rng.uniform(-t_max, t_max, size=(n, 2))
    return np.concatenate([s[:, None], t], axis=1).astype(np.float32)


def render_example(
    verts: np.ndarray,  # (V, 3) posed model-frame vertices
    faces: np.ndarray,
    cam: np.ndarray,  # (3,) [s, tx, ty]
    img_size: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one (RGB uint8, silhouette uint8 (H,W,1)) pair.

    Camera placement mirrors the trainer's visualization math
    (train/trainer.py _log_images): t_z = f / s so that perspective
    projection with focal 0.5*size*f approximates the weak-perspective
    s*(x+t) the losses use; f=50 keeps the approximation within ~1%.
    """
    s, tx, ty = float(cam[0]), float(cam[1]), float(cam[2])
    f = _RENDER_F
    verts_cam = np.asarray(verts, np.float64) + np.array([tx, ty, f / s])
    if rng is None:
        rng = np.random.RandomState(0)
    bg_level = rng.uniform(0.25, 0.9)
    bg = np.clip(
        bg_level + 0.08 * rng.randn(img_size, img_size, 3), 0.0, 1.0
    )
    color = np.clip(np.array([0.68, 0.58, 0.48]) + 0.12 * rng.randn(3), 0.1, 0.95)
    img, mask = rasterize_mesh(
        verts_cam,
        np.asarray(faces),
        img_size,
        img_size,
        focal=0.5 * img_size * f,
        center=np.array([img_size / 2.0, img_size / 2.0]),
        color=color,
        background=bg,
    )
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    sil = (mask.astype(np.uint8) * 255)[..., None]
    return rgb, sil


def project_keypoints_px(joints3d: np.ndarray, cam: np.ndarray, img_size: int):
    """Weak-perspective pixel keypoints — exactly the loss's projection
    (core/projection.py): px = (s*(X+[tx,ty]) + 1) * size/2."""
    s = cam[0]
    xy = s * (joints3d[:, :2] + cam[None, 1:3])
    return (xy + 1.0) * 0.5 * img_size


def render_split(
    model: SMPLModel,
    n: int,
    split_rng: np.random.RandomState,
    img_size: int = 256,
    batch_forward: int = 64,
    device=None,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], Dict[str, np.ndarray], List[int]]:
    """Sample, pose and render one split of ``n`` examples from
    ``split_rng``: (examples [(rgb (H, W, 3) uint8, silhouette (H, W, 1)
    uint8, label (3, 14) f32 [x, y, inside])], {"theta" (n, 72), "beta"
    (n, 10), "cam" (n, 3)}, silhouette pixel counts). The body model runs
    on ``device`` (``cuda`` unless the caller asks for the CPU) in batches
    of ``batch_forward``; the rendering runs on the host."""
    dev = resolve_device(device)
    smpl = model.to(dev)
    faces = np.asarray(model.faces)
    thetas = sample_poses(split_rng, n)
    betas = sample_betas(split_rng, n)
    cams = sample_cams(split_rng, n)
    all_verts, all_joints = [], []
    with torch.no_grad():
        for s0 in range(0, n, batch_forward):
            sl = slice(s0, min(s0 + batch_forward, n))
            out = smpl_forward(
                smpl,
                torch.from_numpy(betas[sl]).to(dev),
                torch.from_numpy(thetas[sl]).to(dev),
                joint_type="lsp",
            )
            all_verts.append(out.verts.cpu().numpy())
            all_joints.append(out.joints.cpu().numpy())
    verts = np.concatenate(all_verts)
    joints = np.concatenate(all_joints)

    examples, sil_pixels = [], []
    for i in range(n):
        rgb, sil = render_example(verts[i], faces, cams[i], img_size, split_rng)
        kp = project_keypoints_px(joints[i], cams[i], img_size)
        inside = (
            (kp[:, 0] >= 0) & (kp[:, 0] < img_size)
            & (kp[:, 1] >= 0) & (kp[:, 1] < img_size)
        )
        label = np.stack(
            [kp[:, 0], kp[:, 1], inside.astype(np.float32)], axis=0
        ).astype(np.float32)  # (3, 14)
        sil_pixels.append(int(sil.astype(bool).sum()))
        examples.append((rgb, sil, label))
    return examples, {"theta": thetas, "beta": betas, "cam": cams}, sil_pixels


def sil_stats(sil_pixels) -> Dict:
    """The silhouette pixel-count distribution that
    ``generate_closed_loop_dataset`` reports (QUALITY.md's statistics)."""
    sil = np.asarray(sil_pixels)
    return {
        "sil_pixels_mean": float(sil.mean()),
        "sil_pixels_p50": float(np.percentile(sil, 50)),
        "sil_pixels_p99": float(np.percentile(sil, 99)),
        "sil_pixels_max": int(sil.max()),
    }


def generate_closed_loop_dataset(
    out_dir: str,
    model: SMPLModel,
    n_train: int = 256,
    n_val: int = 64,
    n_mocap: int = 4096,
    img_size: int = 256,
    seed: int = 0,
    fmt: str = "tfrecord",  # 'tfrecord' | 'npz'
    train_name: str = "lsp_train",
    val_name: str = "lsp_val",
    batch_forward: int = 64,
    device=None,
) -> Dict:
    """Generate a full closed-loop dataset tree under out_dir:

      <train_name>.tfrecords / .npz        images + seg + 14-kp labels
      <val_name>.tfrecords / .npz
      mocap_neutrMosh/neutrSMPL_CMU_synth.(tfrecord|npz)   pose/shape prior
      ground_truth.npz                     thetas/betas/cams per split

    Returns stats including the silhouette pixel-count distribution (the
    basis for the max_silhouette_points default; see QUALITY.md). The body
    model runs on ``device`` (``cuda`` unless the caller asks for the CPU).
    """
    os.makedirs(out_dir, exist_ok=True)
    sil_pixels: List[int] = []
    gt: Dict[str, np.ndarray] = {}

    def make_split(name: str, n: int, split_rng: np.random.RandomState):
        examples, params, sil = render_split(model, n, split_rng, img_size, batch_forward, device)
        sil_pixels.extend(sil)
        for k, v in params.items():
            gt[f"{name}_{k}"] = v
        _write_split(out_dir, name, examples, fmt)
        return len(examples)

    n_tr = make_split(train_name, n_train, np.random.RandomState(seed + 1))
    n_va = make_split(val_name, n_val, np.random.RandomState(seed + 2))

    # mocap prior: the SAME pose/shape distribution the GT was drawn from
    # (the critic's "real" manifold is then exactly the target manifold).
    mocap_pose, mocap_shape = sample_mocap(n_mocap, seed)
    mdir = os.path.join(out_dir, "mocap_neutrMosh")
    os.makedirs(mdir, exist_ok=True)
    if fmt == "tfrecord":
        from . import tfrecords

        tfrecords.create_mocap_tfrecord(
            os.path.join(mdir, "neutrSMPL_CMU_synth.tfrecord"),
            mocap_pose,
            mocap_shape,
        )
    else:
        from .npz_dataset import write_mocap_npz_shard

        write_mocap_npz_shard(
            os.path.join(mdir, "neutrSMPL_CMU_synth.npz"), mocap_pose, mocap_shape
        )

    np.savez(os.path.join(out_dir, "ground_truth.npz"), **gt)
    return {"n_train": n_tr, "n_val": n_va, "n_mocap": n_mocap, **sil_stats(sil_pixels)}


def sample_mocap(n_mocap: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The mocap prior's (pose (n, 72), shape (n, 10)) of the dataset of
    ``seed``, drawn from the ground truth's own distribution."""
    mrng = np.random.RandomState(seed + 3)
    return sample_poses(mrng, n_mocap), sample_betas(mrng, n_mocap)


def _write_split(out_dir: str, name: str, examples, fmt: str) -> None:
    import cv2

    if fmt == "npz":
        from .npz_dataset import write_npz_shard

        jpegs = [cv2.imencode(".jpg", ex[0][:, :, ::-1])[1].tobytes() for ex in examples]
        pngs = [cv2.imencode(".png", ex[1])[1].tobytes() for ex in examples]
        labels = np.stack([ex[2] for ex in examples])
        centers = np.stack(
            [_center_from_label(ex[2]) for ex in examples]
        )
        write_npz_shard(
            os.path.join(out_dir, f"{name}.npz"), jpegs, pngs, labels, centers
        )
        return
    if fmt != "tfrecord":
        raise ValueError(f"unknown fmt {fmt!r}")
    from . import tfrecords

    tf = tfrecords._tf()
    path = os.path.join(out_dir, f"{name}.tfrecords")
    with tf.io.TFRecordWriter(path) as writer:
        for i, (rgb, sil, label) in enumerate(examples):
            img_bytes = cv2.imencode(".jpg", rgb[:, :, ::-1])[1].tobytes()
            seg_bytes = cv2.imencode(".png", sil)[1].tobytes()
            ex = tfrecords.make_image_example(
                img_bytes,
                seg_bytes,
                rgb.shape[0],
                rgb.shape[1],
                _center_from_label(label),
                label,
                f"synth_{i:05d}.jpg",
            )
            writer.write(ex.SerializeToString())


def _center_from_label(label: np.ndarray) -> np.ndarray:
    vis = label[2] > 0
    if not vis.any():
        return np.array([0, 0], np.int32)
    pts = label[:2, vis]
    mn, mx = pts.min(axis=1), pts.max(axis=1)
    return np.round((mn + mx) / 2.0).astype(np.int32)
