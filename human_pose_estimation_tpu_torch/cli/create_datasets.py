"""Offline dataset build (counterpart of
``human_pose_estimation_tpu/cli/create_datasets.py``): converts raw LSP /
LSP-extended / MPII images, UP segmentation PNGs and joints.mat files into
the reference's tfrecord schema (``data/tfrecords.py``), or into npz
shards (``--format npz``, ``data/npz_dataset.py``)::

    python -m human_pose_estimation_tpu_torch.cli.create_datasets \\
        --lsp_dir ... --lsp_seg_dir ... --lsp_joints ... --output_dir datasets

Each dataset converts on its own. The joints of an example are the
joints.mat column of its image NUMBER, not of its position among the
pairs (UP covers only some images); LSP's occlusion flags are inverted to
visibility; MPII's 16 joints are reordered onto LSP's 14; LSP splits into
train and val by image number (``--train_count``). Host only: tfrecords
need TensorFlow, npz needs OpenCV, joints.mat needs SciPy; nothing runs
on the card.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from ..data import tfrecords


def _load_joints_mat(path: str) -> np.ndarray:
    """joints.mat as (3, J, N), from either shipped orientation: LSP
    ships (3, 14, N), LSP-ext (14, 3, N); MPII conversions (3, 16, N) or
    (16, 3, N)."""
    import scipy.io

    joints = np.asarray(scipy.io.loadmat(path)["joints"], np.float32)
    if joints.ndim != 3:
        raise ValueError(f"{path}: expected 3-d joints array, got {joints.shape}")
    if joints.shape[1] == 3 and joints.shape[0] != 3:
        joints = joints.transpose(1, 0, 2)  # (J, 3, N) -> (3, J, N)
    if joints.shape[0] != 3:
        raise ValueError(f"{path}: cannot interpret orientation {joints.shape}")
    return joints


def _joint_indices(pairs) -> list:
    """The joints.mat column of each pair: the first number in its image
    file's name, less one."""
    idxs = []
    for img_path, _ in pairs:
        nums = re.findall(r"\d+", os.path.basename(img_path))
        if not nums:
            raise ValueError(f"no image number in filename: {img_path}")
        idxs.append(int(nums[0]) - 1)
    return idxs


def _npz_writer(path, pairs, joints, visibility_inverted=False, joint_order=None):
    """``create_image_tfrecord``'s conventions, written as an npz shard."""
    from ..data.npz_dataset import convert_images_to_npz_shard

    j = np.asarray(joints, np.float32).copy()
    if joint_order is not None:
        j = j[:, list(joint_order), :]
    if visibility_inverted:
        j[2] = 1.0 - j[2]
    return convert_images_to_npz_shard(path.replace(".tfrecords", ".npz"), pairs, j)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--lsp_dir", default=None, help="LSP images dir")
    p.add_argument("--lsp_seg_dir", default=None, help="LSP UP segmentations dir")
    p.add_argument("--lsp_joints", default=None, help="LSP joints.mat")
    p.add_argument("--lsp_ext_dir", default=None)
    p.add_argument("--lsp_ext_seg_dir", default=None)
    p.add_argument("--lsp_ext_joints", default=None)
    p.add_argument("--mpii_dir", default=None)
    p.add_argument("--mpii_seg_dir", default=None)
    p.add_argument("--mpii_joints", default=None)
    p.add_argument("--train_count", type=int, default=1000, help="LSP images used for train (rest -> val)")
    p.add_argument("--format", choices=("tfrecord", "npz"), default="tfrecord",
                   help="tfrecord = reference-compatible; npz = TF-free shards")
    args = p.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    create = _npz_writer if args.format == "npz" else tfrecords.create_image_tfrecord

    def out(name):
        return os.path.join(args.output_dir, f"{name}.tfrecords")

    if args.lsp_dir:
        joints = _load_joints_mat(args.lsp_joints)
        pairs = tfrecords.pair_lsp(args.lsp_dir, args.lsp_seg_dir)
        # split by image NUMBER (im0001..im<train_count> -> train), so a
        # sparse segmentation set splits where the size table expects
        split = {"lsp_train": [], "lsp_val": []}
        for pair, i in zip(pairs, _joint_indices(pairs)):
            split["lsp_train" if i < args.train_count else "lsp_val"].append((pair, i))
        for name, part in split.items():
            if name == "lsp_val" and not part:
                continue
            n = create(out(name), [q for q, _ in part], joints[:, :, [i for _, i in part]],
                       visibility_inverted=True)  # LSP stores occlusion
            print(f"{name}: {n} examples")

    if args.lsp_ext_dir:
        joints = _load_joints_mat(args.lsp_ext_joints)
        pairs = tfrecords.pair_lsp_ext(args.lsp_ext_dir, args.lsp_ext_seg_dir)
        n = create(out("lsp_ext"), pairs, joints[:, :, _joint_indices(pairs)], visibility_inverted=False)
        print(f"lsp_ext: {n} examples")

    if args.mpii_dir:
        joints = _load_joints_mat(args.mpii_joints)
        pairs = tfrecords.pair_lsp_ext(args.mpii_dir, args.mpii_seg_dir)
        n = create(out("mpii"), pairs, joints[:, :, _joint_indices(pairs)], visibility_inverted=False,
                   joint_order=tfrecords.MPII_TO_LSP)
        print(f"mpii: {n} examples")


if __name__ == "__main__":
    main(sys.argv[1:])
