"""Data layer: host record IO and on-device preprocessing (counterpart of
``human_pose_estimation_tpu/data/__init__.py``).

``make_image_pipeline`` / ``make_mocap_pipeline`` dispatch on
``Config.input_pipeline``, over host pipelines that yield the same
(GenBatch | HostBatch, n_valid) stream, with the augmentation on the
device:

* ``tfrecord`` — tf.data over the reference's tfrecord schema
  (``data/pipeline.ImagePipeline``, ``MocapPipeline``);
* ``npz`` — numpy and OpenCV over npz shards
  (``data/npz_dataset.NpzImagePipeline``);
* ``native`` — the C++ multithreaded decoder over the same npz shards,
  with a prefetch thread (``data/native_pipeline.NativeImagePipeline``);
  its mocap stream is the npz one.

``grain`` raises until it is ported (ROADMAP.md section 1, item 4) rather
than reading the npz shards instead.
"""
from __future__ import annotations

import os
from glob import glob
from typing import List, Optional, Sequence

from ..config import Config

__all__ = ["make_image_pipeline", "make_mocap_pipeline", "npz_mocap_files", "npz_shard_files"]


def npz_shard_files(data_dir: str, datasets: Sequence[str]) -> List[str]:
    """Resolve dataset names to npz shard paths: '<name>.npz' or a sharded
    '<name>/*.npz' directory under data_dir."""
    files: List[str] = []
    for name in datasets:
        single = os.path.join(data_dir, f"{name}.npz")
        if os.path.exists(single):
            files.append(single)
            continue
        hits = sorted(glob(os.path.join(data_dir, name, "*.npz")))
        files += hits if hits else [single]
    return files


def npz_mocap_files(data_dir: str, mocap_datasets: Sequence[str]) -> List[str]:
    """Mocap npz shards, mirroring the tfrecord layout
    (mocap_neutrMosh/neutrSMPL_<name>_*.npz)."""
    files: List[str] = []
    for name in mocap_datasets:
        files += sorted(glob(os.path.join(data_dir, "mocap_neutrMosh", f"neutrSMPL_{name}_*.npz")))
    return files


def _refuse_unported(cfg: Config) -> None:
    if cfg.input_pipeline == "grain":
        raise NotImplementedError(
            "input_pipeline='grain' is not ported yet (ROADMAP.md section 1, item 4); "
            "use input_pipeline='tfrecord', 'npz' or 'native'"
        )


def make_image_pipeline(cfg: Config, datasets: Optional[Sequence[str]] = None, mode: str = "train", **kw):
    """The image pipeline of ``cfg.input_pipeline`` over ``datasets``
    (default ``cfg.datasets``) under ``cfg.data_dir``: ``tfrecord``
    (``data/pipeline.ImagePipeline``), ``npz``
    (``data/npz_dataset.NpzImagePipeline``) or ``native``
    (``data/native_pipeline.NativeImagePipeline``)."""
    _refuse_unported(cfg)
    names = list(datasets if datasets is not None else cfg.datasets)
    if cfg.input_pipeline == "tfrecord":
        from .pipeline import ImagePipeline

        return ImagePipeline(cfg, datasets=names, mode=mode, **kw)
    files = npz_shard_files(cfg.data_dir, names)
    if cfg.input_pipeline == "npz":
        from .npz_dataset import NpzImagePipeline

        # the npz pipeline always augments on the device, as the JAX one does
        kw.pop("device_preprocess", None)
        return NpzImagePipeline(cfg, files, mode=mode, **kw)
    if cfg.input_pipeline == "native":
        from .native_pipeline import NativeImagePipeline

        return NativeImagePipeline(cfg, files, mode=mode, **kw)
    raise ValueError(
        f"unknown input_pipeline {cfg.input_pipeline!r} (expected 'tfrecord', 'npz', 'native', or 'grain')"
    )


def make_mocap_pipeline(cfg: Config, smpl, **kw):
    """The mocap prior stream of ``cfg.input_pipeline`` over
    ``cfg.mocap_datasets`` under ``cfg.data_dir``: tf.data for
    ``tfrecord``, the npz shards for ``npz`` and ``native``."""
    _refuse_unported(cfg)
    if cfg.input_pipeline == "tfrecord":
        from .pipeline import MocapPipeline

        return MocapPipeline(cfg, smpl, **kw)
    from .npz_dataset import NpzMocapPipeline

    return NpzMocapPipeline(cfg, smpl, files=npz_mocap_files(cfg.data_dir, cfg.mocap_datasets), **kw)
