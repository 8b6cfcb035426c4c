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
* ``grain`` — ``grain.MapDataset`` over the npz shards: a seeded
  per-epoch shuffle, decoding in worker processes, a resumable position
  (``data/grain_pipeline.GrainImagePipeline``).

The mocap stream of ``npz``, ``native`` and ``grain`` is the npz one.
Under data parallelism (``shard_by_host`` with more than one rank) only
``tfrecord`` and ``grain`` shard the examples over the ranks; ``npz`` and
``native`` would give every rank the whole dataset, and are refused.
"""
from __future__ import annotations

import os
from glob import glob
from typing import List, Optional, Sequence

from ..config import Config
from ..parallel import mesh as pmesh

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


def make_image_pipeline(cfg: Config, datasets: Optional[Sequence[str]] = None, mode: str = "train", **kw):
    """The image pipeline of ``cfg.input_pipeline`` over ``datasets``
    (default ``cfg.datasets``) under ``cfg.data_dir``: ``tfrecord``
    (``data/pipeline.ImagePipeline``), ``npz``
    (``data/npz_dataset.NpzImagePipeline``), ``native``
    (``data/native_pipeline.NativeImagePipeline``) or ``grain``
    (``data/grain_pipeline.GrainImagePipeline``). ``shard_by_host=True``
    shards the examples over the ranks of a process group; ``npz`` and
    ``native`` cannot, and raise ValueError under more than one rank."""
    names = list(datasets if datasets is not None else cfg.datasets)
    if cfg.input_pipeline == "tfrecord":
        from .pipeline import ImagePipeline

        return ImagePipeline(cfg, datasets=names, mode=mode, **kw)
    files = npz_shard_files(cfg.data_dir, names)
    shard_by_host = bool(kw.pop("shard_by_host", False))
    if cfg.input_pipeline == "grain":
        from .grain_pipeline import GrainImagePipeline

        # grain always augments on the device, as the JAX one does
        kw.pop("device_preprocess", None)
        return GrainImagePipeline(cfg, files, mode=mode, shard_by_host=shard_by_host, **kw)
    # npz and native have no per-rank example sharding: every rank would
    # read the WHOLE dataset (duplicated epochs), so refuse
    if shard_by_host and pmesh.world_size() > 1:
        raise ValueError(
            f"input_pipeline={cfg.input_pipeline!r} cannot shard the input stream across processes; use "
            "input_pipeline='grain' (per-rank example sharding and a resumable iterator) or 'tfrecord' "
            "for data-parallel training"
        )
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
    ``tfrecord``, the npz shards for ``npz``, ``native`` and ``grain``. The
    stream is not sharded over the ranks: every rank draws the same
    samples, as every host of the JAX package shuffles with ``cfg.seed``."""
    if cfg.input_pipeline == "tfrecord":
        from .pipeline import MocapPipeline

        return MocapPipeline(cfg, smpl, **kw)
    from .npz_dataset import NpzMocapPipeline

    return NpzMocapPipeline(cfg, smpl, files=npz_mocap_files(cfg.data_dir, cfg.mocap_datasets), **kw)
