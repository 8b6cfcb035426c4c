"""Export a checkpoint to a self-contained serving artifact (counterpart of
``human_pose_estimation_tpu/cli/export_model.py``), through ``torch.export``.

    python -m human_pose_estimation_tpu_torch.cli.export_model \
        --checkpoint_dir ckpt --smpl_model_path models/model.npz \
        --out model.pt2 [--batch_size 8] [--platforms cuda,cpu]

The artifact (and its .json sidecar) loads with
``infer.export.ExportedPredictor`` and needs only torch on the serving
host: no model code, body-model asset or checkpoint. Runs on ``cuda`` (a
``cuda`` program is traced there; ``--platforms cpu`` alone needs no card
when ``main`` is given ``device="cpu"``).
"""
from __future__ import annotations

import argparse
import sys

from ..config import parse_config


def main(argv=None, device=None) -> dict:
    """``device``: where the predictor is built, ``cuda`` unless the caller
    asks for the CPU. Returns the artifact's metadata."""
    from .. import resolve_device

    dev = resolve_device(device)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--platforms", default="cuda,cpu")
    p.add_argument("--export_dtype", default="uint8", choices=["uint8", "float32"])
    p.add_argument("--calibration", default=None,
                   help="image glob for int8 activation-scale calibration (with --encoder_int8 true)")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)

    from ..infer.export import export_predictor
    from ..infer.predictor import Predictor

    calib = None
    if args.calibration:
        from ..utils.image import load_calibration_images

        calib = load_calibration_images(args.calibration, cfg.img_size)
    if cfg.encoder_int8 and calib is None:
        raise SystemExit(
            "--encoder_int8 exports require --calibration '<glob>' of representative images: an "
            "uncalibrated export would bake the dynamic-scale graph (slower than bf16, see PERF.md)."
        )
    predictor = Predictor(cfg, calibration_images=calib, device=dev)
    meta = export_predictor(
        predictor,
        args.out,
        dtype=args.export_dtype,
        platforms=[s.strip() for s in args.platforms.split(",") if s.strip()],
    )
    print(f"exported {args.out}: {meta}")
    return meta


if __name__ == "__main__":
    main(sys.argv[1:])
