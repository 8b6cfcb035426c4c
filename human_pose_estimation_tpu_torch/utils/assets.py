"""Synthetic SMPL-shaped assets for tests, demos and the smoke run.

Numpy-only copies of ``human_pose_estimation_tpu/utils/assets.py``'s
``synthetic_model`` and ``synthetic_mean_params`` (the same seed gives the
same arrays as the JAX package) and ``write_reference_pickle``.
"""
from __future__ import annotations

import pickle

import numpy as np

from ..core.smpl import SMPL_PARENTS, SMPLModel


def synthetic_model(num_verts: int = 6890, seed: int = 0) -> SMPLModel:
    """Deterministic random SMPL-shaped asset (f32 CPU tensors; move it
    with ``.to(device)``). The kinematic tree is the true SMPL topology;
    the learned tensors are small random numbers so outputs stay O(1)."""
    rng = np.random.RandomState(seed)
    v = num_verts
    v_template = rng.uniform(-1.0, 1.0, size=(v, 3)).astype(np.float32)
    shapedirs = (0.03 * rng.randn(10, v * 3)).astype(np.float32)
    posedirs = (0.01 * rng.randn(207, v * 3)).astype(np.float32)

    def _regressor(rows):
        # each regressed point is a convex combination of ~8 vertices
        reg = np.zeros((v, rows), np.float32)
        for j in range(rows):
            idx = rng.choice(v, size=min(8, v), replace=False)
            w = rng.uniform(0.1, 1.0, size=idx.shape[0])
            reg[idx, j] = (w / w.sum()).astype(np.float32)
        return reg

    j_regressor = _regressor(24)
    joint_regressor = _regressor(19)
    # LBS weights: soft assignment to the nearest joints of a random rest
    # skeleton, normalized
    rest_joints = v_template.T @ j_regressor  # (3, 24)
    d2 = ((v_template[:, :, None] - rest_joints[None]) ** 2).sum(1)  # (v, 24)
    w = np.exp(-d2 / (0.5 + d2.mean()))
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    faces = None
    if v >= 3:
        faces = rng.choice(v, size=(max(4, v // 2), 3)).astype(np.int32)

    return SMPLModel.from_arrays(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        joint_regressor=joint_regressor,
        parents=SMPL_PARENTS,
        faces=faces,
    )


def write_reference_pickle(model: SMPLModel, path: str) -> None:
    """Write ``model`` in the official SMPL pickle layout that
    ``core.smpl.load_model`` reads: f64 arrays, shapedirs (V, 3, 10),
    posedirs (V, 3, 207), sparse J_regressor (24, V) and cocoplus_regressor
    (19, V), kintree_table with the root marked uint32(-1), faces as uint32
    when there are any."""
    import scipy.sparse as sp

    def f64(name):
        return getattr(model, name).detach().cpu().numpy().astype(np.float64)

    v = int(model.v_template.shape[0])
    kintree = np.zeros((2, 24), dtype=np.uint32)
    kintree[0] = np.asarray(model.parents, dtype=np.uint32)
    kintree[0, 0] = np.uint32(0xFFFFFFFF)  # root marker, as in real assets
    kintree[1] = np.arange(24, dtype=np.uint32)
    dd = {
        "v_template": f64("v_template"),
        "shapedirs": f64("shapedirs").T.reshape(v, 3, 10),
        "posedirs": f64("posedirs").T.reshape(v, 3, 207),
        "J_regressor": sp.csc_matrix(f64("j_regressor").T),
        "weights": f64("lbs_weights"),
        "cocoplus_regressor": sp.csc_matrix(f64("joint_regressor").T),
        "kintree_table": kintree,
    }
    if model.faces is not None:
        dd["f"] = np.asarray(model.faces, np.uint32)
    with open(path, "wb") as f:
        pickle.dump(dd, f)


def synthetic_mean_params(seed: int = 1) -> np.ndarray:
    """An 85-d mean Theta ([scale, tx, ty | pose 72 | shape 10]) standing
    in for the real mean-parameter asset (utils/mean_params.py)."""
    rng = np.random.RandomState(seed)
    mean = np.zeros(85, np.float32)
    mean[0] = 0.9
    pose = 0.1 * rng.randn(72).astype(np.float32)
    pose[:3] = 0.0
    pose[0] = np.pi
    mean[3:75] = pose
    mean[75:] = 0.05 * rng.randn(10).astype(np.float32)
    return mean
