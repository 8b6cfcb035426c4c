"""Training entry point (counterpart of ``human_pose_estimation_tpu/cli/
train.py``).

    python -m human_pose_estimation_tpu_torch.cli.train --input_pipeline npz \
        --data_dir ... --datasets lsp_train,lsp_ext --use_mesh_repro_loss true

Makes the run directory and its params.json, the image, validation and
mocap pipelines, and a ``Trainer``; trains, then saves the state. Runs on
``cuda``.

Data-parallel over N processes (one card each)::

    torchrun --nproc_per_node=N -m human_pose_estimation_tpu_torch.cli.train \
        --input_pipeline grain --batch_size B ...

``--batch_size`` is then the per-process batch (the global batch is N x
B) and the training stream is sharded over the processes by example
(``input_pipeline`` 'grain' or 'tfrecord'; 'npz' and 'native' refuse).
Rank 0 names the run directory and writes params.json. One process
needs no torchrun: a group of one computes the same bits and only adds
the collectives' host time.
"""
from __future__ import annotations

import sys

from ..config import parse_config, prepare_dirs, save_config


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    from .. import resolve_device

    from ..parallel import mesh as pmesh

    dev = resolve_device(device)
    multihost = pmesh.maybe_initialize_distributed(dev)
    cfg = parse_config(argv)
    if pmesh.rank() == 0:
        cfg = prepare_dirs(cfg)
        save_config(cfg)
    cfg = pmesh.broadcast_object(cfg)  # one run directory for every rank

    from ..core.smpl import load_model
    from ..data import make_image_pipeline, make_mocap_pipeline
    from ..train.trainer import Trainer

    smpl = load_model(cfg.smpl_model_path)
    train_pipe = make_image_pipeline(
        cfg, mode="train", shard_by_host=multihost, device_preprocess=not cfg.fuse_preprocess, device=dev
    )
    val_pipe = (
        make_image_pipeline(cfg, datasets=cfg.val_datasets, mode="val", shuffle=True, repeat=True, device=dev)
        if cfg.use_validation
        else None
    )
    need_mocap = (not cfg.encoder_only) or cfg.do_bone_evaluation
    mocap_pipe = (
        make_mocap_pipeline(cfg, smpl, device_forward=not cfg.fuse_preprocess, device=dev) if need_mocap else None
    )
    trainer = Trainer(
        cfg, dataset=train_pipe, mocap_dataset=mocap_pipe, val_dataset=val_pipe, smpl=smpl, device=dev
    )
    trainer.train()
    trainer.save()


if __name__ == "__main__":
    main(sys.argv[1:])
