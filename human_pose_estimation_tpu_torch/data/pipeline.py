"""The device half of the input pipeline (counterpart of the device half of
``human_pose_estimation_tpu/data/pipeline.py``): the host pipelines decode
records into fixed uint8 canvases, and ``DevicePreprocessor`` copies a
batch of them to the device and runs the augmentation and the silhouette
extraction there (``data/augment.py``), producing the ``GenBatch`` that the
training step consumes. The tf.data pipelines are not ported yet.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..train.step import GenBatch
from .augment import AugmentConfig, augment_batch, extract_silhouette

__all__ = ["DevicePreprocessor", "person_window_half", "to_device"]


def person_window_half(cfg: Config, augment: bool) -> int:
    """Half-extent of the source-resolution person window that covers
    every possible device-side crop: the img_size crop at the smallest
    scale spans img_size / scale_min source pixels, plus the centre jitter
    and rounding slack. Shared by the host pipelines so that their
    geometry agrees."""
    if augment:
        return int(np.ceil(cfg.img_size / (2.0 * min(cfg.scale_min, 1.0))) + cfg.trans_max + 4)
    return int(np.ceil(cfg.img_size / 2.0) + 4)


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or a tensor on ``device``. A host array bound for the
    card goes through pinned memory and the copy does not block the host
    (a tensor already pinned is copied as it is)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class DevicePreprocessor:
    """``augment_batch`` then ``extract_silhouette`` on the device, as one
    call: ``prep(host_batch, generator) -> GenBatch``."""

    def __init__(self, cfg: Config, augment: bool = True, device=None):
        """``device``: ``cuda`` unless the caller asks for the CPU."""
        self.aug_cfg = AugmentConfig(
            out_size=cfg.img_size,
            trans_max=cfg.trans_max,
            scale_min=cfg.scale_min,
            scale_max=cfg.scale_max,
            augment=augment,
        )
        self.max_sil = cfg.max_silhouette_points
        self.device = resolve_device(device)

    def __call__(self, host_batch: Mapping, generator: Optional[torch.Generator] = None) -> GenBatch:
        """host_batch: {"image" (N, Hc, Wc, 3) uint8, "seg" (N, Hc, Wc, 1)
        uint8, "hw" (N, 2), "center" (N, 2), "label" (N, 3, 19)} of numpy
        arrays or (pinned) CPU tensors. ``generator`` (on the device) draws
        the augmentation; ``augment=False`` needs none."""
        with torch.profiler.record_function("DevicePreprocessor"):
            b = {k: to_device(host_batch[k], self.device) for k in ("image", "seg", "hw", "center", "label")}
            crops, crop_segs, label = augment_batch(
                b["image"], b["seg"], b["hw"], b["center"], b["label"], generator, self.aug_cfg
            )
            pts, mask = extract_silhouette(crop_segs, self.max_sil)
        return GenBatch(images=crops, seg_points=pts, seg_mask=mask, kp2d=label)
