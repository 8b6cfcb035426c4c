"""Input pipelines: host record IO feeding the device half (counterpart of
``human_pose_estimation_tpu/data/pipeline.py``).

* host (tf.data, ``ImagePipeline``): record read -> shuffle (on the
  serialized bytes, before decode) -> repeat -> JPEG / PNG decode -> a
  person window at source resolution fitted into a fixed uint8 canvas
  (``_fit_to_canvas``) -> batch;
* device (``DevicePreprocessor``): the batch of canvases is copied to the
  device, which runs the augmentation and the silhouette extraction
  (``data/augment.py``), producing the ``GenBatch`` that the training step
  consumes.

``MocapPipeline`` reads the mocap prior's tfrecords and poses each batch
with one batched body-model forward on the device. TensorFlow is imported
when a tf.data pipeline is built, never with this module, and sees no GPU.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..parallel import mesh as pmesh
from ..train.step import GenBatch, HostBatch, mocap_batch
from ..utils.tracing import span
from . import tfrecords
from .augment import AugmentConfig, augment_batch, extract_silhouette

__all__ = [
    "DevicePreprocessor",
    "ImagePipeline",
    "MocapPipeline",
    "person_window_half",
    "to_device",
]


def _tf():
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")  # the host half: the card is torch's
    return tf


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

    def __init__(self, cfg: Config, augment: bool = True, device=None, global_draws: bool = False):
        """``device``: ``cuda`` unless the caller asks for the CPU.
        ``global_draws``: under a process group the augmentation draws for
        the global batch and keeps this rank's rows (the fused training
        step, ``train/step.py``); a pipeline's preprocessor draws per rank
        from its own generator, as in the JAX package."""
        self.aug_cfg = AugmentConfig(
            out_size=cfg.img_size,
            trans_max=cfg.trans_max,
            scale_min=cfg.scale_min,
            scale_max=cfg.scale_max,
            augment=augment,
        )
        self.max_sil = cfg.max_silhouette_points
        self.device = resolve_device(device)
        self.global_draws = global_draws

    def __call__(self, host_batch: Mapping, generator: Optional[torch.Generator] = None) -> GenBatch:
        """host_batch: {"image" (N, Hc, Wc, 3) uint8, "seg" (N, Hc, Wc, 1)
        uint8, "hw" (N, 2), "center" (N, 2), "label" (N, 3, 19)} of numpy
        arrays or (pinned) CPU tensors. ``generator`` (on the device) draws
        the augmentation; ``augment=False`` needs none."""
        with span("step.prep"):
            b = {k: to_device(host_batch[k], self.device) for k in ("image", "seg", "hw", "center", "label")}
            crops, crop_segs, label = augment_batch(
                b["image"], b["seg"], b["hw"], b["center"], b["label"], generator, self.aug_cfg,
                global_draws=self.global_draws,
            )
            pts, mask = extract_silhouette(crop_segs, self.max_sil)
        return GenBatch(images=crops, seg_points=pts, seg_mask=mask, kp2d=label)


def _fit_to_canvas(tf, parsed, canvas: int, window_half=None):
    """Crop a person window at source resolution, then scale it to fit a
    fixed uint8 canvas (top-left), moving the keypoints and the centre with
    it, in TensorFlow ops (the geometry of ``npz_dataset._fit_to_canvas_np``
    and of the native decoder).

    ``window_half``: half-extent in pixels of the window around the person
    centre that covers every crop the device augmentation can take
    (``person_window_half``). Cropping it first keeps a small person in a
    large frame at (near) source resolution, as the reference crops at
    original resolution (ref src/data_loader.py:160-213); window edges cut
    by the image border keep the reference's edge-replicate behaviour (the
    device resampler clamps at the true image edge there)."""
    img = parsed["image"]
    seg = parsed["seg"]
    h = parsed["height"]
    w = parsed["width"]
    label = parsed["label"]
    center = parsed["center"]

    if window_half is not None:
        half = tf.cast(window_half, tf.int32)
        x0 = tf.clip_by_value(center[0] - half, 0, tf.maximum(w - 1, 0))
        y0 = tf.clip_by_value(center[1] - half, 0, tf.maximum(h - 1, 0))
        x1 = tf.maximum(tf.minimum(w, center[0] + half), x0 + 1)
        y1 = tf.maximum(tf.minimum(h, center[1] + half), y0 + 1)
        img = tf.image.crop_to_bounding_box(img, y0, x0, y1 - y0, x1 - x0)
        seg = tf.image.crop_to_bounding_box(seg, y0, x0, y1 - y0, x1 - x0)
        h = y1 - y0
        w = x1 - x0
        fx0 = tf.cast(x0, tf.float32)
        fy0 = tf.cast(y0, tf.float32)
        label = tf.stack([label[0] - fx0, label[1] - fy0, label[2]], axis=0)
        center = center - tf.stack([x0, y0])

    longest = tf.maximum(h, w)
    scale = tf.minimum(1.0, tf.cast(canvas, tf.float32) / tf.cast(longest, tf.float32))
    new_h = tf.cast(tf.math.floor(tf.cast(h, tf.float32) * scale), tf.int32)
    new_w = tf.cast(tf.math.floor(tf.cast(w, tf.float32) * scale), tf.int32)
    img = tf.image.resize(img, (new_h, new_w), method="bilinear")
    seg = tf.image.resize(seg, (new_h, new_w), method="bilinear")
    fy = tf.cast(new_h, tf.float32) / tf.cast(h, tf.float32)
    fx = tf.cast(new_w, tf.float32) / tf.cast(w, tf.float32)
    xy = tf.stack([label[0] * fx, label[1] * fy, label[2]], axis=0)
    center = tf.cast(
        tf.stack([tf.cast(center[0], tf.float32) * fx, tf.cast(center[1], tf.float32) * fy]),
        tf.int32,
    )
    img = tf.image.pad_to_bounding_box(tf.cast(tf.round(img), tf.uint8), 0, 0, canvas, canvas)
    seg = tf.image.pad_to_bounding_box(tf.cast(tf.round(seg), tf.uint8), 0, 0, canvas, canvas)
    return {"image": img, "seg": seg, "hw": tf.stack([new_h, new_w]), "center": center, "label": xy}


class ImagePipeline:
    """tf.data over image tfrecords -> (GenBatch, n_valid).

    mode='train': shuffle(10000) + repeat + augmentation (ref
    src/trainer.py:154-159). mode='val': deterministic by default (no
    jitter / flip, no shuffle, one pass). The reference runs the same
    random augmentation on validation data (read_data is shared,
    src/data_loader.py:87-93); pass augment=True / shuffle=True /
    repeat=True for that behaviour.
    """

    def __init__(
        self,
        cfg: Config,
        datasets: Optional[Sequence[str]] = None,
        files: Optional[Sequence[str]] = None,
        mode: str = "train",
        augment: Optional[bool] = None,
        canvas: int = 256,
        shuffle: Optional[bool] = None,
        repeat: Optional[bool] = None,
        seed: Optional[int] = None,
        device_preprocess: bool = True,
        cache: bool = False,
        shard_by_host: bool = False,
        device=None,
    ):
        """``device``: where the augmentation runs, ``cuda`` unless the
        caller asks for the CPU. ``device_preprocess=False`` yields
        ``HostBatch``es of canvases for the fused training step instead.
        The augmentation draws from a ``torch.Generator`` on the device
        seeded with ``seed`` (default ``cfg.seed``); the record order from
        tf.data's seeded shuffle.

        ``cache`` decodes and fits every
        example once into memory and shuffles / repeats from there (a small
        corpus cycled many times); only the shuffled order differs from the
        uncached stream.

        ``shard_by_host``: under a process group of more than one rank,
        each rank reads every R-th example from its rank on
        (``ds.shard``), and ``batch_size`` is the per-rank batch. The shard
        is taken over examples, never over files: files of different sizes
        would give the ranks different example counts."""
        tf = _tf()
        self.cfg = cfg
        self.canvas = canvas
        self.batch_size = cfg.batch_size
        if files is None:
            files = tfrecords.record_files(cfg.data_dir, datasets if datasets is not None else cfg.datasets)
        self.files = list(files)
        augment = (mode == "train") if augment is None else augment
        shuffle = (mode == "train") if shuffle is None else shuffle
        repeat = (mode == "train") if repeat is None else repeat
        self.device_preprocess = device_preprocess
        self.prep = DevicePreprocessor(cfg, augment=augment, device=device) if device_preprocess else None
        seed = cfg.seed if seed is None else seed
        self.generator = (
            torch.Generator(device=self.prep.device).manual_seed(seed) if device_preprocess else None
        )
        self.window_half = person_window_half(cfg, augment)

        ds = tf.data.TFRecordDataset(self.files)
        if shard_by_host and pmesh.world_size() > 1:
            ds = ds.shard(pmesh.world_size(), pmesh.rank())
        half = self.window_half

        def parse(s):
            return _fit_to_canvas(tf, tfrecords.parse_image_example(s), canvas, window_half=half)

        if cache:
            ds = ds.map(parse, num_parallel_calls=tf.data.AUTOTUNE).cache()
            if shuffle:
                ds = ds.shuffle(10000, seed=cfg.seed)
            if repeat:
                ds = ds.repeat()
        else:
            if shuffle:
                ds = ds.shuffle(10000, seed=cfg.seed)
            if repeat:
                ds = ds.repeat()
            ds = ds.map(parse, num_parallel_calls=tf.data.AUTOTUNE)
        ds = ds.batch(self.batch_size, drop_remainder=repeat)
        self.ds = ds.prefetch(tf.data.AUTOTUNE)

    def __iter__(self):
        """Yields (GenBatch | HostBatch, n_valid): n_valid < batch_size only
        on the last, partial batch of a pipeline that does not repeat, whose
        tail is padded to the batch size with empty examples: zero canvases
        and labels with a 1x1 extent, as the npz and native pipelines pad
        (the JAX pipeline pads the extent with 0 too, and its augmentation
        then turns the padded images into NaN)."""
        for host_batch in self.ds.as_numpy_iterator():
            n = host_batch["image"].shape[0]
            if n < self.batch_size:
                pad = self.batch_size - n
                host_batch = {
                    k: np.concatenate([v, (np.ones if k == "hw" else np.zeros)((pad, *v.shape[1:]), v.dtype)], axis=0)
                    for k, v in host_batch.items()
                }
            if self.device_preprocess:
                yield self.prep(host_batch, self.generator), n
            else:
                yield HostBatch(**{k: host_batch[k] for k in ("image", "seg", "hw", "center", "label")}), n


class MocapPipeline:
    """tf.data over the mocap prior's tfrecords: batches of batch_size *
    num_stage (pose, shape) pairs, to pair one to one with the three
    stages' fakes (ref src/trainer.py:163), forever. With ``device_forward``
    each batch is posed by one batched body-model forward on the device
    into a ``MocapBatch`` (in place of the reference's per-sample forward,
    src/data_loader.py:139-143); without it the raw (pose, shape) tensors
    on the device are yielded (the fused step's input)."""

    def __init__(
        self,
        cfg: Config,
        smpl,
        files: Optional[Sequence[str]] = None,
        shuffle: bool = True,
        device_forward: bool = True,
        device=None,
    ):
        """``device``: ``cuda`` unless the caller asks for the CPU."""
        tf = _tf()
        self.batch = cfg.batch_size * cfg.num_stage
        self.device_forward = device_forward
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        if files is None:
            files = tfrecords.mocap_record_files(cfg.data_dir, cfg.mocap_datasets)
        if not files:
            raise FileNotFoundError(f"no mocap tfrecords for {cfg.mocap_datasets} under {cfg.data_dir}")
        ds = tf.data.TFRecordDataset(list(files))
        if shuffle:
            ds = ds.shuffle(10000, seed=cfg.seed)
        ds = ds.repeat().map(tfrecords.parse_mocap_example_tf, num_parallel_calls=tf.data.AUTOTUNE)
        self.ds = ds.batch(self.batch, drop_remainder=True).prefetch(tf.data.AUTOTUNE)

    def __iter__(self):
        for pose, shape in self.ds.as_numpy_iterator():
            pose, shape = to_device(pose, self.device), to_device(shape, self.device)
            yield mocap_batch(self.smpl, pose, shape) if self.device_forward else (pose, shape)
