"""Migrate a trained reference checkpoint into this package (counterpart
of ``human_pose_estimation_tpu/cli/import_checkpoint.py``).

Reads a tf.train.Checkpoint written by the reference Trainer and writes a
step-0 checkpoint (the ``utils/checkpoint.py`` layout) that this package's
Trainer, Predictor and the serve / export CLIs restore::

    python -m human_pose_estimation_tpu_torch.cli.import_checkpoint \\
        --reference_checkpoint_dir /path/to/ref/ckpts \\
        --checkpoint_dir /path/to/new/dir \\
        --smpl_model_path models/model.npz

Needs TensorFlow on the host (CPU only; reading only). See
models/port_reference.py for the mean theta and the optimizer moments. A
directory that already holds a step at or above 0 is not written to; the
command says so.
"""
from __future__ import annotations

import argparse
import sys

from ..config import parse_config


def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for the CPU. Returns
    (state, inital_theta, whether the step was written)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--reference_checkpoint_dir", required=True, help="directory holding the reference's ckpt-* files")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)

    from ..models.port_reference import import_reference_checkpoint

    state, inital_theta, written = import_reference_checkpoint(
        args.reference_checkpoint_dir, cfg.checkpoint_dir, cfg, device=device
    )
    if not written:
        print(
            f"wrote nothing: {cfg.checkpoint_dir} already holds a step at or above 0 "
            "(checkpoints are never rewritten); use an empty --checkpoint_dir"
        )
        return state, inital_theta, written
    n_params = sum(v.numel() for v in state.gen_params())
    print(
        f"imported reference checkpoint -> {cfg.checkpoint_dir} (step 0, {n_params:,} generator params, "
        f"mean_theta[:5]={inital_theta[0, :5]})"
    )
    return state, inital_theta, written


if __name__ == "__main__":
    main(sys.argv[1:])
