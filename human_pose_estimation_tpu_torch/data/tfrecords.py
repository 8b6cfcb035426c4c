"""TFRecord schema: creation (offline) and parsing (input pipeline) — the
port's own copy of ``human_pose_estimation_tpu/data/tfrecords.py``.

The record schema is byte-compatible with the reference's, so existing
datasets load unchanged:

  image/{encoded, seg_gt, height, width, center, x, y, visibility,
         filename, face_pts}                       (image examples)
  {pose (72,), shape (10,)}                        (mocap examples)

The dataset-size table (``NUM_EXAMPLES``, ``num_examples``) drives the
trainer's epoch accounting. TensorFlow is host-side record IO only, and is
imported inside the writers and parsers (``_tf``), never with this module:
the card's machine has none. Nothing here touches the device.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Hard-coded dataset sizes (ref src/data_loader.py:18-42).
NUM_EXAMPLES: Dict[str, int] = {
    "lsp_few_new": 10,
    "lsp_few_new_1": 10,
    "lsp_train": 1000,
    "lsp_val": 1000,
    "lsp_ext": 8642,
    "lsp_single": 1,
    "lsp_single_new": 1,
    "single_new_try": 1,
    "lsp_16": 16,
    "lsp_32": 32,
    "CMU": 3934267,
    "jointLim": 181968,
}

# MPII 16-joint -> LSP 14-joint reorder (ref create_dataset.py:109-125).
MPII_TO_LSP = (0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 8, 9)


def num_examples(datasets) -> int:
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    return sum(NUM_EXAMPLES[d] for d in datasets)


def record_files(data_dir: str, datasets: Sequence[str]):
    """Resolve dataset names to tfrecord paths (ref get_all_files,
    data_utils.py:83-106 — returning actual files, fixing quirk §8.2).

    h36m / mpi_inf_3dhp are rejected loudly: the reference lists their
    sharded path patterns (data_utils.py:94-100, inherited from HMR) but
    its parse_example_proto cannot read those records' 3D-annotation
    schema — and neither can this build's parse_image_example. Silent
    acceptance would glob zero files and train on nothing."""
    files: List[str] = []
    for name in datasets:
        if name in ("h36m", "mpi_inf_3dhp"):
            raise ValueError(
                f"dataset '{name}' uses HMR's 3D-annotation tfrecord "
                "schema, which parse_image_example does not read (the "
                "reference only carries the path pattern, ref "
                "data_utils.py:94-100; its parser cannot read them "
                "either). Convert to this schema with "
                "data/tfrecords.make_image_example or extend the parser."
            )
        pattern = os.path.join(data_dir, f"{name}.tfrecords")
        hits = sorted(glob(pattern))
        files += hits if hits else [pattern]
    return files


def mocap_record_files(data_dir: str, mocap_datasets: Sequence[str]):
    """(ref src/data_loader.py:99-107)"""
    files: List[str] = []
    for name in mocap_datasets:
        files += sorted(
            glob(
                os.path.join(
                    data_dir, "mocap_neutrMosh", f"neutrSMPL_{name}_*.tfrecord"
                )
            )
        )
    return files


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _tf():
    import tensorflow as tf

    return tf


def make_image_example(
    image_bytes: bytes,
    seg_bytes: bytes,
    height: int,
    width: int,
    center_xy: np.ndarray,  # (2,) int
    label: np.ndarray,  # (3, 14) [x, y, vis]
    filename: str,
    face_pts: Optional[np.ndarray] = None,  # (3, 5)
):
    tf = _tf()
    if face_pts is None:
        face_pts = np.zeros((3, 5), np.float32)

    def _bytes(v):
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=[v]))

    def _int64(v):
        return tf.train.Feature(
            int64_list=tf.train.Int64List(value=np.asarray(v, np.int64).reshape(-1))
        )

    def _float(v):
        return tf.train.Feature(
            float_list=tf.train.FloatList(value=np.asarray(v, np.float32).reshape(-1))
        )

    feats = {
        "image/encoded": _bytes(image_bytes),
        "image/seg_gt": _bytes(seg_bytes),
        "image/height": _int64([height]),
        "image/width": _int64([width]),
        "image/filename": _bytes(filename.encode()),
        "image/center": _int64(center_xy.reshape(2, 1)),
        "image/x": _float(label[0]),
        "image/y": _float(label[1]),
        "image/visibility": _int64(label[2].astype(np.int64)),
        "image/face_pts": _float(face_pts),
    }
    return tf.train.Example(features=tf.train.Features(feature=feats))


def make_mocap_example(pose: np.ndarray, shape: np.ndarray):
    tf = _tf()
    feats = {
        "pose": tf.train.Feature(
            float_list=tf.train.FloatList(value=np.asarray(pose, np.float32).reshape(-1))
        ),
        "shape": tf.train.Feature(
            float_list=tf.train.FloatList(value=np.asarray(shape, np.float32).reshape(-1))
        ),
    }
    return tf.train.Example(features=tf.train.Features(feature=feats))


def center_from_visible(label: np.ndarray) -> np.ndarray:
    """Person center = bbox center of the visible keypoints
    (ref create_dataset.py:25-27)."""
    vis = label[2] > 0
    pts = label[:2, vis]
    mn, mx = pts.min(axis=1), pts.max(axis=1)
    return np.round((mn + mx) / 2.0).astype(np.int32)


def create_image_tfrecord(
    out_path: str,
    pairs: Iterable[Tuple[str, str]],  # (image_path, seg_path)
    joints: np.ndarray,  # (3, 14, N) from joints.mat
    visibility_inverted: bool = False,  # LSP stores "occluded"; ext stores "visible"
    joint_order: Optional[Sequence[int]] = None,  # e.g. MPII_TO_LSP
) -> int:
    """Write an image+segmentation tfrecord (ref create_dataset.py:17-140).

    Handles the reference's dataset conventions: LSP's inverted visibility
    flag (quirk, create_dataset.py:19-22), 3-channel segmentation PNGs
    reduced to 1 channel (create_dataset.py:36-40), and the MPII joint
    remap. Returns the number of examples written.
    """
    tf = _tf()
    count = 0
    with tf.io.TFRecordWriter(out_path) as writer:
        for idx, (img_path, seg_path) in enumerate(pairs):
            label = np.asarray(joints[:, :, idx], np.float32).copy()
            if joint_order is not None:
                label = label[:, list(joint_order)]
            if visibility_inverted:
                label[2] = 1.0 - label[2]
            if not (label[2] > 0).any():
                continue
            img_bytes = tf.io.read_file(img_path).numpy()
            img = tf.io.decode_image(img_bytes, channels=3).numpy()
            seg = tf.io.decode_image(tf.io.read_file(seg_path)).numpy()
            if seg.ndim == 3 and seg.shape[-1] > 1:
                seg = seg[..., :1]  # 3ch -> 1ch (ref :36-40)
            elif seg.ndim == 2:
                seg = seg[..., None]
            seg_bytes = tf.io.encode_png(seg.astype(np.uint8)).numpy()
            center = center_from_visible(label)
            ex = make_image_example(
                img_bytes,
                seg_bytes,
                img.shape[0],
                img.shape[1],
                center,
                label,
                os.path.basename(img_path),
            )
            writer.write(ex.SerializeToString())
            count += 1
    return count


def create_mocap_tfrecord(out_path: str, poses: np.ndarray, shapes: np.ndarray) -> int:
    tf = _tf()
    with tf.io.TFRecordWriter(out_path) as writer:
        for pose, shape in zip(poses, shapes):
            writer.write(make_mocap_example(pose, shape).SerializeToString())
    return len(poses)


# ---------------------------------------------------------------------------
# Filename pairing (ref create_dataset.py:144-170)
# ---------------------------------------------------------------------------


def pair_lsp(img_dir: str, seg_dir: str) -> List[Tuple[str, str]]:
    """Pair LSP images with their UP segmentation PNGs; images without a
    segmentation are skipped (the UP release does not cover every LSP
    image — the reference's dense vstack pairing, ref
    create_dataset.py:145-149, crashes on such sets)."""
    imgs = sorted(glob(os.path.join(img_dir, "im*.jpg")))
    pairs = []
    for p in imgs:
        s = os.path.join(seg_dir, os.path.basename(p)[:-4] + "_segmentation.png")
        if os.path.exists(s):
            pairs.append((p, s))
    return pairs


def pair_lsp_ext(img_dir: str, seg_dir: str) -> List[Tuple[str, str]]:
    segs = sorted(glob(os.path.join(seg_dir, "*.png")))
    pairs = []
    for s in segs:
        stem = os.path.basename(s).split("_")[0]
        pairs.append((os.path.join(img_dir, stem + ".png"), s))
    return pairs


# ---------------------------------------------------------------------------
# Parsing (host side, feeding the device pipeline)
# ---------------------------------------------------------------------------


def parse_image_example(serialized):
    """Decode one image example to host tensors (ref parse_example_proto,
    data_utils.py:11-69). Returns dict with image uint8 (H, W, 3), seg
    uint8 (H, W, 1), label (3, 19) with 5 face points appended, center
    (2,) int32."""
    tf = _tf()
    feature_map = {
        "image/encoded": tf.io.FixedLenFeature([], tf.string),
        "image/seg_gt": tf.io.FixedLenFeature([], tf.string),
        "image/height": tf.io.FixedLenFeature([], tf.int64),
        "image/width": tf.io.FixedLenFeature([], tf.int64),
        "image/filename": tf.io.FixedLenFeature([], tf.string),
        "image/center": tf.io.FixedLenFeature((2, 1), tf.int64),
        "image/visibility": tf.io.FixedLenFeature((1, 14), tf.int64),
        "image/x": tf.io.FixedLenFeature((1, 14), tf.float32),
        "image/y": tf.io.FixedLenFeature((1, 14), tf.float32),
        "image/face_pts": tf.io.FixedLenFeature(
            (1, 15), tf.float32, default_value=[0.0] * 15
        ),
    }
    f = tf.io.parse_single_example(serialized, feature_map)
    image = tf.io.decode_jpeg(f["image/encoded"], channels=3)
    seg = tf.io.decode_image(f["image/seg_gt"], channels=1, expand_animations=False)
    x = tf.cast(f["image/x"], tf.float32)
    y = tf.cast(f["image/y"], tf.float32)
    vis = tf.cast(f["image/visibility"], tf.float32)
    label = tf.concat([x, y, vis], axis=0)  # (3, 14)
    face = tf.reshape(tf.cast(f["image/face_pts"], tf.float32), (3, 5))
    label = tf.concat([label, face], axis=1)  # (3, 19)
    return {
        "image": image,
        "seg": seg,
        "height": tf.cast(f["image/height"], tf.int32),
        "width": tf.cast(f["image/width"], tf.int32),
        "center": tf.cast(tf.reshape(f["image/center"], (2,)), tf.int32),
        "label": label,
        "filename": f["image/filename"],
    }


def parse_mocap_example_tf(serialized):
    """(ref parse_mocap_example, data_utils.py:109-127)"""
    tf = _tf()
    f = tf.io.parse_single_example(
        serialized,
        {
            "pose": tf.io.FixedLenFeature((72,), tf.float32),
            "shape": tf.io.FixedLenFeature((10,), tf.float32),
        },
    )
    return f["pose"], f["shape"]
