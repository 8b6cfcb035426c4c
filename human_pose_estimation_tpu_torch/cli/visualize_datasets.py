"""Dataset visual-inspection CLI (counterpart of
``human_pose_estimation_tpu/cli/visualize_datasets.py``): renders batches
of the tf.data image pipeline, and with ``--mocap`` meshes of the mocap
stream's shapes, to PNGs::

    python -m human_pose_estimation_tpu_torch.cli.visualize_datasets \\
        --out_dir /tmp/vis --num_batches 2 [--mocap] --data_dir ... --datasets ...

Host tool: the pipelines need TensorFlow (CPU host only); the
augmentation runs on ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import parse_config


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    from .. import resolve_device

    dev = resolve_device(device)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out_dir", default="dataset_vis")
    p.add_argument("--num_batches", type=int, default=1)
    p.add_argument("--mocap", action="store_true", help="also render mocap meshes")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)
    os.makedirs(args.out_dir, exist_ok=True)

    from ..core.smpl import load_model
    from ..data.pipeline import ImagePipeline, MocapPipeline
    from ..viz.datasets import draw_smpl_meshes, show_image_batch

    it = iter(ImagePipeline(cfg, mode="train", device=dev))
    for i in range(args.num_batches):
        batch, _ = next(it)
        path = os.path.join(args.out_dir, f"images_batch{i}.png")
        show_image_batch(batch, out_path=path)
        print(f"wrote {path}")

    if args.mocap:
        smpl = load_model(cfg.smpl_model_path)
        mocap = next(iter(MocapPipeline(cfg, smpl, device=dev)))
        # the rest pose with the first samples' shapes
        path = os.path.join(args.out_dir, "mocap_meshes.png")
        draw_smpl_meshes(
            smpl, poses=np.zeros((2, 72), np.float32), shapes=mocap.shapes[:2].cpu().numpy(), out_path=path
        )
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
