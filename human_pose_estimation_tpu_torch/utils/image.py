"""Host-side image helpers for inference/demo preprocessing (the port's
own copy of ``human_pose_estimation_tpu/utils/image.py``).

Scale an image, center-crop it to the model input size with edge padding,
and report the proc_param that viz.renderer.get_original needs to undo the
transform. OpenCV is imported inside the functions that resize or read
images, never with this module.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def resize_img(img: np.ndarray, scale_factor: float):
    import cv2

    new_size = (
        int(round(img.shape[1] * scale_factor)),
        int(round(img.shape[0] * scale_factor)),
    )
    resized = cv2.resize(img, new_size)
    actual = np.array(
        [new_size[1] / float(img.shape[0]), new_size[0] / float(img.shape[1])]
    )
    return resized, actual


def scale_and_crop(
    image: np.ndarray, scale: float, center: np.ndarray, img_size: int
) -> Tuple[np.ndarray, Dict]:
    """Scale then crop img_size x img_size around center (edge-padded).

    Returns (crop, proc_param) with proc_param = {scale, start_pt, end_pt,
    img_size} consumed by get_original.
    """
    image_scaled, scale_factors = resize_img(image, scale)
    center_scaled = np.round(center * scale_factors[::-1]).astype(int)

    margin = int(img_size / 2)
    image_pad = np.pad(
        image_scaled, ((margin,), (margin,), (0,)), mode="edge"
    )
    center_pad = center_scaled + margin
    start_pt = center_pad - margin
    end_pt = center_pad + margin
    crop = image_pad[start_pt[1] : end_pt[1], start_pt[0] : end_pt[0], :]
    proc_param = {
        "scale": scale,
        "start_pt": start_pt,
        "end_pt": end_pt,
        "img_size": img_size,
    }
    return crop, proc_param


def preprocess_for_inference(
    img: np.ndarray, img_size: int = 224
) -> Tuple[np.ndarray, Dict, np.ndarray]:
    """Demo-path preprocessing (ref preview.py:18-35): scale the longest
    side to img_size, center-crop, normalize to [-1, 1]."""
    if img.shape[2] == 4:
        img = img[:, :, :3]
    scale = float(img_size) / np.max(img.shape[:2])
    center = np.round(np.array(img.shape[:2])[::-1] / 2.0).astype(int)
    crop, proc_param = scale_and_crop(img, scale, center, img_size)
    norm = 2.0 * (crop.astype(np.float32) / 255.0) - 1.0
    return norm, proc_param, img


def load_calibration_images(
    pattern, img_size: int = 224, limit: int = 16
) -> "np.ndarray | None":
    """Load + preprocess up to `limit` images — from a glob pattern or an
    explicit path list — into an (N, img_size, img_size, 3) float batch
    in [-1, 1]: the int8 activation-scale calibration input shared by the
    predict / serve / export_model CLIs. Unreadable files are skipped;
    returns None when nothing loads."""
    import cv2

    if isinstance(pattern, (list, tuple)):
        paths = list(pattern)[:limit]
    else:
        from glob import glob

        paths = sorted(glob(pattern))[:limit]
    imgs = []
    for p in paths:
        raw = cv2.imread(p)
        if raw is None:
            continue
        imgs.append(
            preprocess_for_inference(
                cv2.cvtColor(raw, cv2.COLOR_BGR2RGB), img_size
            )[0]
        )
    if not imgs:
        return None
    return np.stack(imgs)
