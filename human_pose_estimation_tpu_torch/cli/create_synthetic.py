"""Generate a closed-loop synthetic ground-truth dataset tree (counterpart
of ``human_pose_estimation_tpu/cli/create_synthetic.py``).

    python -m human_pose_estimation_tpu_torch.cli.create_synthetic \
        --out_dir datasets_synth [--n_train 512 --n_val 128 \
        --img_size 256 --fmt tfrecord --num_verts 6890]

Renders the procedural rigged human (utils/synthetic_human.py) with
sampled (theta, beta, cam) into reference-schema records + a mocap prior
drawn from the same pose distribution + ground_truth.npz with the
generating parameters (data/synthetic.py). Stand-in for the licensed
LSP/UP/MoSh assets in end-to-end runs. Writing the records needs OpenCV
(and TensorFlow for ``--fmt tfrecord``); the body model runs on the card
unless ``main`` is given another device.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None, device=None) -> dict:
    """``device``: where the body model poses the samples, ``cuda`` unless
    the caller asks for the CPU. Prints and returns the dataset's
    statistics."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_val", type=int, default=128)
    p.add_argument("--n_mocap", type=int, default=8192)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--num_verts", type=int, default=6890)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fmt", default="tfrecord", choices=["tfrecord", "npz"])
    p.add_argument("--train_name", default="lsp_train")
    p.add_argument("--val_name", default="lsp_val")
    p.add_argument("--model_out", default="", help="also save the generating SMPL asset here (.npz)")
    args = p.parse_args(argv)

    from ..core.smpl import save_model_npz
    from ..data.synthetic import generate_closed_loop_dataset
    from ..utils.synthetic_human import synthetic_human_model

    model = synthetic_human_model(num_verts=args.num_verts)
    stats = generate_closed_loop_dataset(
        args.out_dir,
        model,
        n_train=args.n_train,
        n_val=args.n_val,
        n_mocap=args.n_mocap,
        img_size=args.img_size,
        seed=args.seed,
        fmt=args.fmt,
        train_name=args.train_name,
        val_name=args.val_name,
        device=device,
    )
    if args.model_out:
        save_model_npz(model, args.model_out)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
