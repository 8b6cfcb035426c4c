"""The traffic generator of whole-image, multi-person cells: every input is
made here from the run's seed and the cell's ``traffic`` parameters, on
the host, in the form a host pipeline hands over (``train.step.
CrowdHostBatch``'s fields).

* ``canvases``: batches of uint8 square images filled with random RGB,
  each holding 1 to ``slots`` people (uniform), each a filled figure
  (``traffic.py``'s two ellipses and four limbs) at a height uniform in
  ``[min_height, max_height]`` pixels placed wholly inside the image; each
  person's silhouette is bit k of the image's uint8 mask (k its slot, so
  that people who overlap keep their whole silhouettes), its centre the
  figure's centre, and 19 keypoints on it in the (3, 19) layout; the
  slots past the image's people are padded with zeros and ``present`` 0.
* ``mocap``: raw (pose (M, 3 x 55), shape (M, 10)) samples for SMPL-X, as a
  mocap stream hands them over (std 0.2 and 0.4), the eyes' rotations 0.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .traffic import _BOXES, _ELLIPSES, _JOINTS, rng  # noqa: F401  the figure and the streams

_TOP, _BOTTOM, _HALF_WIDTH = 72.0, 70.0, 27.0  # the figure's extent at scale 1
EYES = (23, 24)


def canvases(r: np.random.Generator, count: int, n: int, canvas: int, slots: int, min_height: float,
             max_height: float) -> List[Dict[str, np.ndarray]]:
    joints = np.asarray(_JOINTS, np.float32)
    out = []
    for _ in range(count):
        image = r.integers(0, 256, (n, canvas, canvas, 3), dtype=np.uint8)
        seg = np.zeros((n, canvas, canvas), np.uint8)
        center = np.zeros((n, slots, 2), np.int32)
        label = np.zeros((n, slots, 3, 19), np.float32)
        present = np.zeros((n, slots), np.uint8)
        for b in range(n):
            for k in range(int(r.integers(1, slots + 1))):
                s = r.uniform(min_height, max_height) / (_TOP + _BOTTOM)
                cx = int(r.integers(int(np.ceil(_HALF_WIDTH * s)), canvas - int(np.ceil(_HALF_WIDTH * s))))
                cy = int(r.integers(int(np.ceil(_TOP * s)), canvas - int(np.ceil(_BOTTOM * s))))
                x0, x1 = max(cx - int(_HALF_WIDTH * s) - 1, 0), min(cx + int(_HALF_WIDTH * s) + 2, canvas)
                y0, y1 = max(cy - int(_TOP * s) - 1, 0), min(cy + int(_BOTTOM * s) + 2, canvas)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                fig = np.zeros(yy.shape, bool)
                for ex, ey, ax, ay in _ELLIPSES:
                    fig |= ((xx - cx - s * ex) / (s * ax)) ** 2 + ((yy - cy - s * ey) / (s * ay)) ** 2 < 1.0
                for bx, by, ax, ay in _BOXES:
                    fig |= (np.abs(xx - cx - s * bx) < s * ax) & (np.abs(yy - cy - s * by) < s * ay)
                seg[b, y0:y1, x0:x1] |= fig.astype(np.uint8) << k
                center[b, k] = cx, cy
                label[b, k, 0] = cx + s * joints[:, 0] + r.standard_normal(19)
                label[b, k, 1] = cy + s * joints[:, 1] + r.standard_normal(19)
                label[b, k, 2] = r.random(19) > 0.1
                present[b, k] = 1
        out.append({"image": image, "seg": seg, "center": center, "label": label, "present": present})
    return out


def mocap(r: np.random.Generator, count: int, m: int, joints: int = 55):
    out = []
    for _ in range(count):
        pose = (0.2 * r.standard_normal((m, joints, 3))).astype(np.float32)
        pose[:, list(EYES)] = 0.0
        out.append((pose.reshape(m, 3 * joints), (0.4 * r.standard_normal((m, 10))).astype(np.float32)))
    return out
