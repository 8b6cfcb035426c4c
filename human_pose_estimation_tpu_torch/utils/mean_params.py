"""Mean SMPL parameter (Theta-bar) loading — the port's own copy of
``human_pose_estimation_tpu/utils/mean_params.py``."""
from __future__ import annotations

import os

import numpy as np

THETA_DIM = 85


def load_mean_theta(path: str) -> np.ndarray:
    """The (1, 85) initial parameter vector [scale=0.9, tx=0, ty=0 | mean
    pose with the global rotation zeroed and pose[0]=pi | mean shape].

    Reads the reference's .h5 asset (keys 'pose' (72,), 'shape' (10,)) or
    an .npz with the same keys; a missing file gives the neutral fallback
    (zeros with the same cam/pose conventions).
    """
    mean = np.zeros((1, THETA_DIM), np.float32)
    mean[0, 0] = 0.9  # initial camera scale
    pose = np.zeros(72, np.float32)
    shape = np.zeros(10, np.float32)
    if path and os.path.exists(path):
        if path.endswith(".npz"):
            z = np.load(path)
            pose = np.asarray(z["pose"], np.float32).reshape(-1)
            shape = np.asarray(z["shape"], np.float32).reshape(-1)
        else:
            import h5py

            with h5py.File(path, "r") as f:
                pose = np.asarray(f["pose"], np.float32).reshape(-1)
                shape = np.asarray(f["shape"], np.float32).reshape(-1)
    # zero global rotation, then pose[0]=pi for an upright projection
    pose[:3] = 0.0
    pose[0] = np.pi
    mean[0, 3:75] = pose
    mean[0, 75:] = shape
    return mean
