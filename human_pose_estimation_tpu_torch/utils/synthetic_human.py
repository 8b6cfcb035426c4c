"""Procedural human-shaped SMPL asset: a rigged capsule body.

`utils.assets.synthetic_model` produces random tensors with SMPL shapes —
good for numerics, useless for *capability* validation: its renders are
blobs, so nothing image-shaped can be learned from them and silhouette
statistics are meaningless. This module builds a deterministic, rigged,
human-proportioned mesh on the TRUE SMPL kinematic tree:

* tapered-capsule limbs/torso/skull around a T-pose rest skeleton
  (~1.7 units tall, pelvis at the origin, y-up — the real SMPL frame);
* LBS weights that follow SMPL semantics (a bone segment rides its
  PARENT joint's rotation, blending to the child joint near the end);
* a joint regressor whose rows are uniform weights over the vertex ring
  centered on each joint — so regressed joints track shape deformation
  exactly, like the real asset's learned regressor;
* a cocoplus/LSP 19-keypoint regressor mapped onto the same rings
  (+ nose/eyes/ears picked from skull-ring vertices);
* shape blendshapes with semantic axes (height, girth, leg length) so
  beta has visible, learnable effect.

This is the ground-truth generator for the closed-loop training-quality
experiments (data/synthetic.py): sample (theta, beta, cam) -> render ->
train the full hybrid recipe -> assert pose recovery. The reference has
no such harness; its quality oracle is a licensed-data eval
(ref src/trainer.py:882-995), which cannot run hermetically.

The port's copy of ``human_pose_estimation_tpu/utils/synthetic_human.py``:
the construction is numpy throughout and gives the same arrays bit for
bit; the model comes back as f32 CPU tensors, or on ``device``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..core.smpl import SMPL_PARENTS, SMPLModel

# T-pose rest skeleton: absolute joint positions (x, y, z), y-up, pelvis
# at the origin, arms out along +-x. Proportions loosely anthropometric;
# total height ~1.7 units.
_REST_JOINTS = np.array(
    [
        (0.00, 0.00, 0.00),  # 0 pelvis
        (0.09, -0.06, 0.00),  # 1 L hip
        (-0.09, -0.06, 0.00),  # 2 R hip
        (0.00, 0.12, 0.00),  # 3 spine1
        (0.10, -0.48, 0.00),  # 4 L knee
        (-0.10, -0.48, 0.00),  # 5 R knee
        (0.00, 0.26, 0.00),  # 6 spine2
        (0.11, -0.88, 0.02),  # 7 L ankle
        (-0.11, -0.88, 0.02),  # 8 R ankle
        (0.00, 0.38, 0.00),  # 9 spine3
        (0.11, -0.93, 0.14),  # 10 L foot
        (-0.11, -0.93, 0.14),  # 11 R foot
        (0.00, 0.52, 0.00),  # 12 neck
        (0.07, 0.47, 0.00),  # 13 L collar
        (-0.07, 0.47, 0.00),  # 14 R collar
        (0.00, 0.62, 0.02),  # 15 head
        (0.20, 0.48, 0.00),  # 16 L shoulder
        (-0.20, 0.48, 0.00),  # 17 R shoulder
        (0.46, 0.46, 0.00),  # 18 L elbow
        (-0.46, 0.46, 0.00),  # 19 R elbow
        (0.70, 0.45, 0.00),  # 20 L wrist
        (-0.70, 0.45, 0.00),  # 21 R wrist
        (0.79, 0.44, 0.00),  # 22 L hand
        (-0.79, 0.44, 0.00),  # 23 R hand
    ],
    np.float64,
)

# Capsule radius at each joint (ring radius where a bone ends there).
_RADII = np.array(
    [
        0.11,  # pelvis
        0.085, 0.085,  # hips
        0.125,  # spine1
        0.062, 0.062,  # knees
        0.135,  # spine2
        0.045, 0.045,  # ankles
        0.125,  # spine3
        0.040, 0.040,  # feet
        0.048,  # neck
        0.060, 0.060,  # collars
        0.055,  # head (base; skull profile bulges past it)
        0.058, 0.058,  # shoulders
        0.046, 0.046,  # elbows
        0.035, 0.035,  # wrists
        0.032, 0.032,  # hands
    ],
    np.float64,
)

_HEAD_JOINT = 15
_NECK_JOINT = 12
# cocoplus keypoints 0-13 (LSP order) -> SMPL joint whose ring regresses it
# (public cocoplus joint semantics: R ankle, R knee, R hip, L hip, L knee,
# L ankle, R wrist, R elbow, R shoulder, L shoulder, L elbow, L wrist,
# neck, head-top).
_COCO14_TO_SMPL = (8, 5, 2, 1, 4, 7, 21, 19, 17, 16, 18, 20, 12, 15)


def _ring_basis(axis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    ref = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(axis, ref)) > 0.95:
        ref = np.array([1.0, 0.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    return u, v


def _build(
    spacing: float, ring_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[int, List[int]], Dict[str, List[int]], np.ndarray]:
    """Generate (verts, lbs_weights, radial_dirs, joint_rings, skull_info,
    faces) at the given ring spacing."""
    verts: List[np.ndarray] = []
    weights: List[np.ndarray] = []
    radial: List[np.ndarray] = []  # unit radial offset * local radius
    faces: List[Tuple[int, int, int]] = []
    joint_rings: Dict[int, List[int]] = {}
    skull: Dict[str, List[int]] = {"mid_ring": [], "top_ring": []}

    def add_tube(parent: int, child: int, t_max: float = 1.0, profile=None):
        p = _REST_JOINTS[parent]
        c = _REST_JOINTS[child]
        length = np.linalg.norm(c - p) * t_max
        n_rings = max(2, int(round(length / spacing)) + 1)
        axis = (c - p) / max(np.linalg.norm(c - p), 1e-9)
        u, v = _ring_basis(axis)
        ring_ids: List[List[int]] = []
        ts = np.linspace(0.0, t_max, n_rings)
        for t in ts:
            center = p + t * (c - p)
            if profile is None:
                r = (1.0 - min(t, 1.0)) * _RADII[parent] + min(t, 1.0) * _RADII[child]
            else:
                r = profile(t)
            # SMPL LBS semantics: the bone parent->child rides the PARENT
            # joint's rotation; blend to the child joint over the last 30%
            # so the next segment bends smoothly.
            s = 0.5 * np.clip((min(t, 1.0) - 0.7) / 0.3, 0.0, 1.0)
            w = np.zeros(24)
            w[parent] = 1.0 - s
            w[child] = s
            ids = []
            for k in range(ring_size):
                phi = 2.0 * np.pi * k / ring_size
                rad_dir = np.cos(phi) * u + np.sin(phi) * v
                ids.append(len(verts))
                verts.append(center + r * rad_dir)
                weights.append(w)
                radial.append(r * rad_dir)
            ring_ids.append(ids)
        # side quads -> triangles
        for i in range(n_rings - 1):
            a, b = ring_ids[i], ring_ids[i + 1]
            for k in range(ring_size):
                k2 = (k + 1) % ring_size
                faces.append((a[k], a[k2], b[k2]))
                faces.append((a[k], b[k2], b[k]))
        # end caps: planar fans across the first/last ring
        for ring in (ring_ids[0], ring_ids[-1]):
            for k in range(1, ring_size - 1):
                faces.append((ring[0], ring[k], ring[k + 1]))
        return ring_ids, ts

    # torso + limbs: every non-root bone of the kinematic tree
    for child in range(1, 24):
        parent = SMPL_PARENTS[child]
        if child == _HEAD_JOINT:
            # skull: extend past the head joint with a bulge profile that
            # closes at the crown.
            r_neck, r_head = _RADII[_NECK_JOINT], 0.105
            def skull_profile(t, r0=r_neck, r1=r_head):
                if t <= 0.15:
                    return r0
                s = min((t - 0.15) / 1.1, 1.0)
                return r0 + (r1 - r0) * np.sin(s * np.pi) + 0.01
            rings, ts = add_tube(parent, child, t_max=1.35, profile=skull_profile)
            # mid-skull ring (eyes/ears/nose) ~ t=0.9; crown = last ring
            mid = int(np.argmin(np.abs(ts - 0.9)))
            skull["mid_ring"] = rings[mid]
            skull["top_ring"] = rings[-1]
            # the joint-15 ring is the one nearest t=1
            j15 = int(np.argmin(np.abs(ts - 1.0)))
            joint_rings[child] = rings[j15]
        else:
            rings, ts = add_tube(parent, child)
            joint_rings[child] = rings[-1]
            if parent == 0 and 0 not in joint_rings:
                joint_rings[0] = rings[0]

    return (
        np.asarray(verts),
        np.asarray(weights),
        np.asarray(radial),
        joint_rings,
        skull,
        np.asarray(faces, np.int32),
    )


def synthetic_human_model(
    num_verts: int = 6890,
    ring_size: int = 12,
    seed: int = 0,
    device=None,
) -> SMPLModel:
    """Deterministic rigged human-shaped SMPL asset with ~num_verts
    vertices (never more; padded up to exactly num_verts with inert
    duplicate vertices so downstream shapes match the real asset).
    f32 tensors on the CPU, or on ``device`` when one is given.
    """
    # Bisect ring spacing so the construction lands just under num_verts.
    lo, hi = 0.002, 0.25  # spacing: small -> many verts
    built = None
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        b = _build(mid, ring_size)
        if b[0].shape[0] <= num_verts:
            built = b
            hi = mid
        else:
            lo = mid
    if built is None:
        raise ValueError(f"num_verts={num_verts} too small for ring_size={ring_size}")
    verts, lbs_w, radial, joint_rings, skull, faces = built
    n_real = verts.shape[0]
    pad = num_verts - n_real
    if pad:
        # inert duplicates of the pelvis-area ring: correct weights, never
        # referenced by faces or regressors.
        idx = np.asarray(joint_rings[0])[np.arange(pad) % len(joint_rings[0])]
        verts = np.concatenate([verts, verts[idx]])
        lbs_w = np.concatenate([lbs_w, lbs_w[idx]])
        radial = np.concatenate([radial, radial[idx]])

    v = num_verts
    j_regressor = np.zeros((v, 24), np.float32)
    for j, ring in joint_rings.items():
        j_regressor[ring, j] = 1.0 / len(ring)

    # cocoplus 19: 14 LSP keypoints from joint rings; head-top from the
    # crown ring; nose/eyes/ears from single mid-skull ring vertices.
    joint_regressor = np.zeros((v, 19), np.float32)
    for c, sj in enumerate(_COCO14_TO_SMPL):
        ring = skull["top_ring"] if c == 13 else joint_rings[sj]
        joint_regressor[ring, c] = 1.0 / len(ring)
    mid_ring = skull["mid_ring"]
    if mid_ring:
        centers = verts[mid_ring]
        ring_c = centers.mean(axis=0)
        ang = np.arctan2(centers[:, 0] - ring_c[0], centers[:, 2] - ring_c[2])
        # nose at +z (ang 0), eyes at +-25 deg, ears at +-90 deg
        for c, target in ((14, 0.0), (15, 0.45), (16, -0.45), (17, 1.57), (18, -1.57)):
            k = int(np.argmin(np.abs(np.angle(np.exp(1j * (ang - target))))))
            joint_regressor[mid_ring[k], c] = 1.0

    # shape blendshapes: semantic axes + small smooth noise
    rng = np.random.RandomState(seed)
    shapedirs = np.zeros((10, v, 3), np.float64)
    shapedirs[0, :, 1] = 0.10 * verts[:, 1]  # beta0: height stretch
    shapedirs[1] = 0.50 * radial  # beta1: girth (radial inflate)
    legs = verts[:, 1] < -0.05
    shapedirs[2, legs, 1] = 0.06 * verts[legs, 1]  # beta2: leg length
    for i in range(3, 10):
        freq = rng.uniform(2.0, 6.0, size=3)
        phase = rng.uniform(0, 2 * np.pi, size=3)
        field = 0.006 * np.sin(verts @ np.diag(freq) + phase)
        shapedirs[i] = field * (1.0 + 0.3 * rng.randn(1, 3))
    shapedirs = shapedirs.reshape(10, v * 3).astype(np.float32)

    posedirs = (1e-3 * rng.randn(207, v * 3)).astype(np.float32)

    model = SMPLModel.from_arrays(
        v_template=verts,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_w,
        joint_regressor=joint_regressor,
        parents=SMPL_PARENTS,
        faces=faces,
    )
    return model if device is None else model.to(resolve_device(device))
