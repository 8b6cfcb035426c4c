"""Build an encoder-donor checkpoint from Keras ResNet weights
(counterpart of ``human_pose_estimation_tpu/cli/import_encoder.py``).

The reference initializes its encoder with
``keras.applications.ResNet50(weights='imagenet')`` at model build time.
Here the Keras weights are ported once into a step-0 checkpoint (the
``utils/checkpoint.py`` layout), and any number of training runs point at
it with ``--init_encoder_from``, which grafts the encoder's weights and
BN statistics into a fresh state (``Trainer._graft_encoder``)::

    # 'imagenet' downloads through Keras; a local .h5 path does not;
    # 'none' / 'random' is Keras's own random init
    python -m human_pose_estimation_tpu_torch.cli.import_encoder \\
        --checkpoint_dir runs/imagenet_donor \\
        --smpl_model_path models/model.npz \\
        [--keras_weights imagenet | /path/to/resnet50_notop.h5]

    python -m human_pose_estimation_tpu_torch.cli.train ... \\
        --init_encoder_from runs/imagenet_donor

The port needs TensorFlow on the host (CPU only); nothing of it survives
into the checkpoint. ``write_donor`` is the TensorFlow-free half (ported
weights in, checkpoint out) and runs on ``cuda`` unless asked otherwise.
As with the JAX package's Orbax manager, a directory that already holds a
step at or above 0 is not written to; the command says so.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Tuple

import torch

from ..config import Config, parse_config


def write_donor(cfg: Config, encoder_state: Dict[str, torch.Tensor], device=None) -> Tuple[object, bool]:
    """A fresh ``create_train_state`` with ``encoder_state`` (a
    ``port_keras.port_resnet`` state dict) as its encoder, saved at step 0
    under ``cfg.checkpoint_dir``. Returns (state, whether the step was
    written). Raises when the ported tensors do not fit the configured
    encoder (``encoder_depth``)."""
    from ..core.smpl import load_model
    from ..train.state import create_train_state
    from ..utils import checkpoint as ckpt
    from ..utils.mean_params import load_mean_theta

    smpl = load_model(cfg.smpl_model_path)
    state = create_train_state(smpl, load_mean_theta(cfg.mean_params_path), cfg, device=device, seed=cfg.seed)
    encoder = state.hmr.encoder
    own = encoder.state_dict()
    if set(own) != set(encoder_state) or any(tuple(v.shape) != tuple(encoder_state[k].shape) for k, v in own.items()):
        raise ValueError(
            f"ported Keras ResNet-{cfg.encoder_depth} does not match this model's encoder structure "
            "(check --encoder_depth)"
        )
    encoder.load_state_dict(encoder_state)
    return state, ckpt.save_train_state(cfg.checkpoint_dir, state, step=0)


def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for the CPU. Returns
    (state, whether the step was written)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument(
        "--keras_weights",
        default="imagenet",
        help="'imagenet' (downloads via keras), 'none' / 'random', or a local Keras .h5 path",
    )
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)

    from ..models.port_keras import load_imagenet_resnet

    weights = None if args.keras_weights.lower() in ("none", "random") else args.keras_weights
    encoder_state = load_imagenet_resnet(depth=cfg.encoder_depth, weights=weights)
    state, written = write_donor(cfg, encoder_state, device=device)
    if not written:
        print(
            f"wrote nothing: {cfg.checkpoint_dir} already holds a step at or above 0 "
            "(checkpoints are never rewritten); use an empty --checkpoint_dir"
        )
        return state, written
    n = sum(v.numel() for v in state.hmr.encoder.parameters())
    print(
        f"wrote Keras ResNet-{cfg.encoder_depth} donor checkpoint -> {cfg.checkpoint_dir} "
        f"(step 0, {n:,} encoder params); use with --init_encoder_from"
    )
    return state, written


if __name__ == "__main__":
    main(sys.argv[1:])
