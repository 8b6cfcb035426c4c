"""Metric / image logging in TensorBoard event files (the port's own copy
of ``human_pose_estimation_tpu/utils/summary.py``).

Separate training / validation writers, per-step scalars and rendered
images. tensorboardX is imported when a writer with a log directory is
made; where it is missing the writer keeps only its in-memory record
(``history``, ``images``), which the tests read.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class SummaryWriter:
    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self.history: List[Tuple[str, int, float]] = []
        # the last image per tag: one HWC array per tag keeps memory bounded
        self.images: dict = {}
        self._tb = None
        if logdir is not None:
            try:
                from tensorboardX import SummaryWriter as TBWriter

                self._tb = TBWriter(logdir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value, step: int) -> None:
        self.history.append((tag, int(step), float(value)))
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.images[tag] = (int(step), img)
        if self._tb is not None:
            self._tb.add_image(tag, img, int(step), dataformats="HWC")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
