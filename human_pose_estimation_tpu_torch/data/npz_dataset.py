"""TensorFlow-free dataset streams over npz shards (counterpart of
``human_pose_estimation_tpu/data/npz_dataset.py``): the host decodes
encoded images with OpenCV into fixed uint8 canvases and the device runs
the augmentation (``data/pipeline.DevicePreprocessor``); the mocap stream
reads (pose, shape) pairs and poses them on the device.

Image shard layout (``np.savez``, object arrays for the bytes):
  jpeg (N,) object — encoded RGB JPEG bytes
  png  (N,) object — encoded 1-channel segmentation PNG bytes
  label (N, 3, 19) float32 — [x, y, vis] rows, 14 joints + 5 face points
  center (N, 2) int32 — person centre [cx, cy]
Mocap shard layout: pose (N, 72) axis-angle, shape (N, 10) betas.

OpenCV is imported where an image is decoded, not with this module, so
the mocap stream and the shard writers need none.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..train.step import mocap_batch
from .pipeline import DevicePreprocessor, person_window_half, to_device

__all__ = [
    "NpzImagePipeline",
    "NpzMocapPipeline",
    "convert_images_to_npz_shard",
    "convert_mocap_tfrecords_to_npz",
    "write_mocap_npz_shard",
    "write_npz_shard",
]


def write_npz_shard(
    out_path: str,
    jpeg_bytes: Sequence[bytes],
    png_bytes: Sequence[bytes],
    labels: np.ndarray,  # (N, 3, >=14)
    centers: np.ndarray,  # (N, 2)
) -> int:
    """Write an image shard; labels with fewer than 19 points get empty
    face points. Returns the number of examples."""
    n = len(jpeg_bytes)
    lab = np.asarray(labels, np.float32)
    if lab.shape[2] < 19:
        lab = np.concatenate([lab, np.zeros((n, 3, 19 - lab.shape[2]), np.float32)], axis=2)
    np.savez(
        out_path,
        jpeg=np.asarray(list(jpeg_bytes), dtype=object),
        png=np.asarray(list(png_bytes), dtype=object),
        label=lab,
        center=np.asarray(centers, np.int32),
    )
    return n


def convert_images_to_npz_shard(out_path: str, pairs, joints: np.ndarray) -> int:
    """Build an image shard from (image_path, seg_path) pairs and a (3, 14,
    N) joints array (the inputs of ``tfrecords.create_image_tfrecord``):
    the image files' bytes as they are, the segmentations re-encoded as
    PNG, examples without a visible joint skipped. Needs OpenCV."""
    import cv2

    from .tfrecords import center_from_visible

    jpegs, pngs, labels, centers = [], [], [], []
    for idx, (img_path, seg_path) in enumerate(pairs):
        label = np.asarray(joints[:, :, idx], np.float32)
        if not (label[2] > 0).any():
            continue
        with open(img_path, "rb") as f:
            img_bytes = f.read()
        seg = cv2.imread(seg_path, cv2.IMREAD_GRAYSCALE)
        ok, png = cv2.imencode(".png", seg)
        if not ok:
            raise ValueError(f"cannot encode {seg_path!r} as PNG")
        jpegs.append(img_bytes)
        pngs.append(png.tobytes())
        labels.append(label)
        centers.append(center_from_visible(label))
    return write_npz_shard(out_path, jpegs, pngs, np.stack(labels), np.stack(centers))


def _fit_to_canvas_np(img, seg, label, center, canvas: int, window_half=None):
    """Crop a person window at source resolution, then scale it to fit a
    fixed uint8 canvas (top-left), moving the keypoints and the centre with
    it: (image (canvas, canvas, 3), seg (canvas, canvas, 1), label (3, 19),
    center (2,), (h, w) inside the canvas)."""
    import cv2

    h, w = img.shape[:2]
    if window_half is not None and window_half > 0:
        cx, cy = int(center[0]), int(center[1])
        x0 = min(max(cx - window_half, 0), max(w - 1, 0))
        y0 = min(max(cy - window_half, 0), max(h - 1, 0))
        x1 = max(min(w, cx + window_half), x0 + 1)
        y1 = max(min(h, cy + window_half), y0 + 1)
        if (x0, y0, x1, y1) != (0, 0, w, h):
            img = img[y0:y1, x0:x1]
            seg = seg[y0:y1, x0:x1]
            label = np.stack([label[0] - x0, label[1] - y0, label[2]], axis=0)
            center = np.asarray([cx - x0, cy - y0], np.int32)
            h, w = img.shape[:2]
    scale = min(1.0, canvas / max(h, w))
    new_h, new_w = int(np.floor(h * scale)), int(np.floor(w * scale))
    if (new_h, new_w) != (h, w):
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        seg = cv2.resize(seg, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    fy, fx = new_h / h, new_w / w
    label = np.stack([label[0] * fx, label[1] * fy, label[2]], axis=0)
    center = np.asarray([int(center[0] * fx), int(center[1] * fy)], np.int32)
    img_c = np.zeros((canvas, canvas, 3), np.uint8)
    img_c[:new_h, :new_w] = img
    seg_c = np.zeros((canvas, canvas, 1), np.uint8)
    seg_c[:new_h, :new_w, 0] = seg
    return img_c, seg_c, label.astype(np.float32), center, (new_h, new_w)


class NpzImagePipeline:
    """npz shards -> host decode into canvases -> device augmentation.
    Yields (GenBatch, n_valid), the last batch of a pass padded with empty
    examples when it does not repeat (and dropped when it does)."""

    def __init__(
        self,
        cfg: Config,
        files: Sequence[str],
        mode: str = "train",
        augment: Optional[bool] = None,
        canvas: int = 256,
        shuffle: Optional[bool] = None,
        repeat: Optional[bool] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        """``device``: where the augmentation runs, ``cuda`` unless the
        caller asks for the CPU. The example order comes from a numpy
        ``RandomState(seed)``, as in the JAX pipeline; the augmentation
        draws from a ``torch.Generator`` on the device with the same seed."""
        self.cfg = cfg
        self.canvas = canvas
        self.batch_size = cfg.batch_size
        self.augment = (mode == "train") if augment is None else augment
        self.shuffle = (mode == "train") if shuffle is None else shuffle
        self.repeat = (mode == "train") if repeat is None else repeat
        self.prep = DevicePreprocessor(cfg, augment=self.augment, device=device)
        self.window_half = person_window_half(cfg, self.augment)
        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator(device=self.prep.device).manual_seed(seed)
        self.np_rng = np.random.RandomState(seed)

        self._examples: List[Tuple[bytes, bytes, np.ndarray, np.ndarray]] = []
        for path in files:
            z = np.load(path, allow_pickle=True)
            self._examples.extend(zip(z["jpeg"], z["png"], z["label"], z["center"]))
        if not self._examples:
            raise FileNotFoundError(f"no examples in npz shards {list(files)}")

    def _decode(self, example):
        import cv2

        jpeg, png, label, center = example
        img = cv2.cvtColor(cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        seg = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_GRAYSCALE)
        return _fit_to_canvas_np(img, seg, label, center, self.canvas, window_half=self.window_half)

    def __iter__(self) -> Iterator:
        empty = (
            np.zeros((self.canvas, self.canvas, 3), np.uint8),
            np.zeros((self.canvas, self.canvas, 1), np.uint8),
            np.zeros((3, 19), np.float32),
            np.zeros(2, np.int32),
            (1, 1),
        )
        while True:
            order = np.arange(len(self._examples))
            if self.shuffle:
                self.np_rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                n = len(idx)
                if n < self.batch_size and self.repeat:
                    continue  # drop the remainder while repeating (as tf.data)
                decoded = [self._decode(self._examples[i]) for i in idx]
                decoded += [empty] * (self.batch_size - n)
                host_batch = {
                    "image": np.stack([d[0] for d in decoded]),
                    "seg": np.stack([d[1] for d in decoded]),
                    "label": np.stack([d[2] for d in decoded]),
                    "center": np.stack([d[3] for d in decoded]),
                    "hw": np.asarray([d[4] for d in decoded], np.int32),
                }
                yield self.prep(host_batch, self.generator), n
            if not self.repeat:
                return


def write_mocap_npz_shard(out_path: str, pose: np.ndarray, shape: np.ndarray) -> int:
    """Write a mocap shard: pose (N, 72) axis-angle, shape (N, 10) betas.
    Returns the number of samples."""
    pose = np.asarray(pose, np.float32)
    shape = np.asarray(shape, np.float32)
    if pose.ndim != 2 or pose.shape[1] != 72:
        raise ValueError(f"pose must be (N, 72), got {pose.shape}")
    if shape.shape != (pose.shape[0], 10):
        raise ValueError(f"shape must be ({pose.shape[0]}, 10), got {shape.shape}")
    np.savez(out_path, pose=pose, shape=shape)
    return pose.shape[0]


def convert_mocap_tfrecords_to_npz(tfrecord_files, out_path: str) -> int:
    """Migrate the reference's mocap tfrecords into one npz shard (once;
    reading the records needs TensorFlow)."""
    from .tfrecords import _tf, parse_mocap_example_tf

    tf = _tf()
    poses, shapes = [], []
    for raw in tf.data.TFRecordDataset(list(tfrecord_files)):
        p, s = parse_mocap_example_tf(raw)
        poses.append(p.numpy())
        shapes.append(s.numpy())
    return write_mocap_npz_shard(out_path, np.stack(poses), np.stack(shapes))


class NpzMocapPipeline:
    """The mocap prior stream: batches of batch_size * num_stage (pose,
    shape) pairs, to pair one to one with the three stages' fakes, forever.
    With ``device_forward`` each batch is posed by one batched body-model
    forward on the device into a ``MocapBatch``; without it the raw (pose,
    shape) tensors on the device are yielded (the fused step's input).

    The order of an epoch derives from (seed, epoch) alone, so ``(epoch,
    pos)`` is the whole state of the stream (``get_state``/``set_state``)."""

    def __init__(
        self,
        cfg: Config,
        smpl,
        files: Sequence[str],
        shuffle: bool = True,
        device_forward: bool = True,
        seed: Optional[int] = None,
        device=None,
    ):
        """``device``: ``cuda`` unless the caller asks for the CPU."""
        poses, shapes = [], []
        for path in files:
            z = np.load(path)
            poses.append(np.asarray(z["pose"], np.float32))
            shapes.append(np.asarray(z["shape"], np.float32))
        if not poses:
            raise FileNotFoundError(f"no mocap npz shards in {list(files)}")
        self.pose = np.concatenate(poses, axis=0)
        self.shape = np.concatenate(shapes, axis=0)
        self.batch = cfg.batch_size * cfg.num_stage
        self.shuffle = shuffle
        self.device_forward = device_forward
        self.seed = cfg.seed if seed is None else seed
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        self._epoch = 0
        self._pos = 0

    def get_state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.pose.shape[0])
        if self.shuffle:
            np.random.RandomState((self.seed + 77003 * epoch) % 2**31).shuffle(order)
        return order

    def __iter__(self):
        n = self.pose.shape[0]
        while True:
            order = self._order(self._epoch)
            while self._pos + self.batch <= n:
                idx = order[self._pos : self._pos + self.batch]
                self._pos += self.batch
                pose = to_device(self.pose[idx], self.device)
                shape = to_device(self.shape[idx], self.device)
                yield mocap_batch(self.smpl, pose, shape) if self.device_forward else (pose, shape)
            self._epoch += 1
            self._pos = 0
