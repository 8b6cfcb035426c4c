"""Checkpoint evaluation entry point (counterpart of
``human_pose_estimation_tpu/cli/validate_checkpoint.py``): loads the
validation set only, forces both losses on, sweeps the latest checkpoint
of ``--checkpoint_dir`` (this package's or the JAX package's) and prints
the mean KPR / MR losses, PCK@0.5, the PCK curve and its AUC.

    python -m human_pose_estimation_tpu_torch.cli.validate_checkpoint \
        --input_pipeline npz --data_dir ... --val_datasets lsp_val \
        --checkpoint_dir ...

Runs on ``cuda``.
"""
from __future__ import annotations

import argparse
import sys

from ..config import parse_config


def main(argv=None, device=None) -> dict:
    """``device``: ``cuda`` unless the caller asks for the CPU. Returns
    the results it prints."""
    from .. import resolve_device

    dev = resolve_device(device)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--draw_best_worst", action="store_true", help="render best/worst validation batches")
    p.add_argument("--draw_every_image", action="store_true", help="render every validation batch")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)
    # both losses on for evaluation
    cfg = cfg.replace(use_mesh_repro_loss=True, use_kpr_loss=True)

    from ..core.smpl import load_model
    from ..data import make_image_pipeline
    from ..train.trainer import Trainer

    smpl = load_model(cfg.smpl_model_path)
    val_pipe = make_image_pipeline(cfg, datasets=cfg.val_datasets, mode="val", device=dev)
    trainer = Trainer(cfg, val_dataset=val_pipe, validation_only=True, smpl=smpl, device=dev)
    results = trainer.validate_checkpoint(
        draw_best_worst=args.draw_best_worst, draw_every_image=args.draw_every_image
    )
    print(results)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
