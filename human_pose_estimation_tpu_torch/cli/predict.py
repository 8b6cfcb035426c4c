"""Offline batched inference (counterpart of ``human_pose_estimation_tpu/
cli/predict.py``): run the predictor over a folder of images (or a glob),
writing per-image SMPL outputs and optional renderings.

    python -m human_pose_estimation_tpu_torch.cli.predict \
        --inputs 'photos/*.jpg' --out_dir preds --render --checkpoint_dir ...

Images are read and preprocessed on the host with OpenCV (scale / crop as
in the demo), batched to the predictor's batch size, and pushed through
the model restored from ``--checkpoint_dir``; with ``--encoder_int8 true``
the int8 encoder, calibrated on (up to 16 of) the inputs. Runs on ``cuda``.
"""
from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np

from ..config import parse_config
from ..utils.image import preprocess_for_inference


def _image_paths(inputs: str):
    if any(c in inputs for c in "*?["):
        paths = sorted(glob(inputs))
    elif os.path.isdir(inputs):
        paths = sorted(glob(os.path.join(inputs, "*")))
    else:
        paths = [inputs]
    return [p for p in paths if p.lower().endswith((".jpg", ".jpeg", ".png"))]


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    from .. import resolve_device

    dev = resolve_device(device)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--inputs", required=True, help="image path, dir, or glob")
    p.add_argument("--out_dir", default="predictions")
    p.add_argument("--render", action="store_true")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)
    os.makedirs(args.out_dir, exist_ok=True)

    import cv2

    from ..infer.predictor import Predictor
    from ..viz.renderer import SMPLRenderer, draw_skeleton, get_original

    paths = _image_paths(args.inputs)
    if not paths:
        print("no images found")
        return

    calib = None
    if cfg.encoder_int8:
        # calibrate the int8 activation scales on the first real inputs
        from ..utils.image import load_calibration_images

        calib = load_calibration_images(paths, cfg.img_size)
    predictor = Predictor(cfg, calibration_images=calib, device=dev)
    renderer = None
    if args.render and predictor.smpl.faces is not None:
        renderer = SMPLRenderer(img_size=cfg.img_size, faces=predictor.smpl.faces)

    b = predictor.batch_size
    for i in range(0, len(paths), b):
        chunk = paths[i : i + b]
        norms, procs, origs = [], [], []
        for path in chunk:
            img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            norm, proc, orig = preprocess_for_inference(img, cfg.img_size)
            norms.append(norm)
            procs.append(proc)
            origs.append(orig)
        out = predictor.predict(np.stack(norms))
        for j, path in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(path))[0]
            np.savez(
                os.path.join(args.out_dir, stem + ".npz"),
                verts=out["generated_verts"][j],
                cams=out["generated_cams"][j],
                joints=out["generated_joints"][j],
                theta=out["theta"][j],
            )
            if renderer is not None:
                kp_px = (out["kp2d"][j][:, :2] + 1) * 0.5 * cfg.img_size
                cam_full, vert_shifted, kp_orig = get_original(
                    procs[j], out["generated_verts"][j], out["generated_cams"][j], kp_px
                )
                over = renderer(vert_shifted, cam=cam_full, img=origs[j])
                over = draw_skeleton(over, kp_orig)
                cv2.imwrite(
                    os.path.join(args.out_dir, stem + "_overlay.png"),
                    cv2.cvtColor(np.asarray(over), cv2.COLOR_RGB2BGR),
                )
        print(f"{min(i + b, len(paths))}/{len(paths)}")
    print(f"wrote outputs to {args.out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
