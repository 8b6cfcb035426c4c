"""Sequential ablation sweep (counterpart of
``human_pose_estimation_tpu/cli/train_many.py``): trains mesh-reprojection
only, then keypoint only, then both, each with its own checkpoint
directory (``<checkpoint_dir>_<suffix>``), run directory (``HMR_<suffix>``
prefix) and params.json::

    python -m human_pose_estimation_tpu_torch.cli.train_many --input_pipeline npz ...

Runs on ``cuda``, one process.
"""
from __future__ import annotations

import sys

from ..config import parse_config, prepare_dirs, save_config

ABLATIONS = (
    dict(use_mesh_repro_loss=True, use_kpr_loss=False, suffix="mr_only"),
    dict(use_mesh_repro_loss=False, use_kpr_loss=True, suffix="kp_only"),
    dict(use_mesh_repro_loss=True, use_kpr_loss=True, suffix="mr_kp"),
)


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    from .. import resolve_device

    dev = resolve_device(device)
    base = parse_config(argv)

    from ..core.smpl import load_model
    from ..data import make_image_pipeline, make_mocap_pipeline
    from ..train.trainer import Trainer

    smpl = load_model(base.smpl_model_path)
    for ab in ABLATIONS:
        cfg = base.replace(
            use_mesh_repro_loss=ab["use_mesh_repro_loss"],
            use_kpr_loss=ab["use_kpr_loss"],
            checkpoint_dir=f"{base.checkpoint_dir}_{ab['suffix']}",
        )
        cfg = prepare_dirs(cfg, prefix=f"HMR_{ab['suffix']}")
        save_config(cfg)
        print(f"=== ablation {ab['suffix']} -> {cfg.model_dir} ===")
        trainer = Trainer(
            cfg,
            dataset=make_image_pipeline(cfg, mode="train", device_preprocess=not cfg.fuse_preprocess, device=dev),
            mocap_dataset=make_mocap_pipeline(cfg, smpl, device_forward=not cfg.fuse_preprocess, device=dev),
            val_dataset=(
                make_image_pipeline(cfg, datasets=cfg.val_datasets, mode="val", shuffle=True, repeat=True, device=dev)
                if cfg.use_validation
                else None
            ),
            smpl=smpl,
            device=dev,
        )
        trainer.train()
        trainer.save()


if __name__ == "__main__":
    main(sys.argv[1:])
