"""The traffic generator: every input a cell feeds the system is made here
from the run's seed and the cell's ``traffic`` parameters, on the host, in
the form a host pipeline or a client hands over.

* ``canvases``: batches of uint8 canvases as the host pipelines fit a
  decoded example into a fixed square (random RGB inside a true extent of
  200 to the canvas side, zeros outside), with a filled human figure in
  the segmentation (two ellipses and four limbs, 3.3k-5.4k pixels at 256
  px, so 2k-9k after a crop at scale 0.8-1.23), the person centre near
  the figure's, and 19 keypoints on it in the (3, 19) layout.
* ``mocap``: raw (pose (M, 72), shape (M, 10)) samples, as a mocap stream
  hands them over (std 0.2 and 0.4).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_ELLIPSES = ((0, -62, 10, 10), (0, -15, 15, 36))
_BOXES = ((-8, 42, 5, 28), (8, 42, 5, 28), (-22, -20, 5, 25), (22, -20, 5, 25))
_JOINTS = (
    (-8, 68), (-8, 42), (-8, 15), (8, 15), (8, 42), (8, 68), (-22, 3), (-22, -20), (-18, -45),
    (18, -45), (22, -20), (22, 3), (0, -50), (0, -72), (0, -62), (3, -65), (-3, -65), (7, -62), (-7, -62),
)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per (seed, purpose)."""
    return np.random.default_rng([int(seed), int(stream)])


def canvases(r: np.random.Generator, count: int, n: int, canvas: int) -> List[Dict[str, np.ndarray]]:
    yy, xx = np.mgrid[:canvas, :canvas]
    out = []
    for _ in range(count):
        image = r.integers(0, 256, (n, canvas, canvas, 3), dtype=np.uint8)
        seg = np.zeros((n, canvas, canvas, 1), np.uint8)
        hw = r.integers(200, canvas + 1, (n, 2)).astype(np.int32)
        center = np.zeros((n, 2), np.int32)
        label = np.zeros((n, 3, 19), np.float32)
        for b, (h, w) in enumerate(hw):
            image[b, h:] = 0
            image[b, :, w:] = 0
            cx, cy = w // 2 + int(r.integers(-10, 11)), h // 2 + int(r.integers(-10, 11))
            k = r.uniform(0.9, 1.15)
            fig = np.zeros((canvas, canvas), bool)
            for ex, ey, ax, ay in _ELLIPSES:
                fig |= ((xx - cx - k * ex) / (k * ax)) ** 2 + ((yy - cy - k * ey) / (k * ay)) ** 2 < 1.0
            for bx, by, ax, ay in _BOXES:
                fig |= (np.abs(xx - cx - k * bx) < k * ax) & (np.abs(yy - cy - k * by) < k * ay)
            seg[b, ..., 0] = 255 * fig
            center[b] = cx, cy
            joints = np.asarray(_JOINTS, np.float32)
            label[b, 0] = cx + k * joints[:, 0] + r.standard_normal(19)
            label[b, 1] = cy + k * joints[:, 1] + r.standard_normal(19)
            label[b, 2] = r.random(19) > 0.1
        out.append({"image": image, "seg": seg, "hw": hw, "center": center, "label": label})
    return out


def mocap(r: np.random.Generator, count: int, m: int):
    return [
        ((0.2 * r.standard_normal((m, 72))).astype(np.float32), (0.4 * r.standard_normal((m, 10))).astype(np.float32))
        for _ in range(count)
    ]

