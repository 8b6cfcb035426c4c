"""Webcam / video / image demo (counterpart of
``human_pose_estimation_tpu/cli/preview.py``): per-frame inference with a
skeleton, mesh or rotated-mesh overlay, switched by key.

Keys: s = skeleton, m = mesh overlay, r = rotated mesh, b = plain frame,
ESC = quit. ``--video`` / ``--image`` read a file instead of the camera,
and ``--out`` writes the annotated result instead of showing it::

    python -m human_pose_estimation_tpu_torch.cli.preview --image photo.jpg --out annotated.png \\
        --checkpoint_dir ... --smpl_model_path ...

Needs OpenCV (imported inside; the card's machine has none); the model
runs on ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import parse_config
from ..utils.image import preprocess_for_inference
from ..viz.renderer import SMPLRenderer, draw_skeleton, get_original


def annotate_frame(frame_bgr, predictor, renderer, img_size: int, mode: str):
    """Run inference on one BGR frame and draw ``mode``'s overlay. Returns
    the annotated BGR uint8 frame, or the input frame when the prediction
    is not finite."""
    import cv2

    rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
    norm, proc_param, _ = preprocess_for_inference(rgb, img_size)
    verts, cams, joints = predictor.predict_single_image(norm)
    verts, cams, joints = verts[0], cams[0], joints[0]
    if not (np.isfinite(verts).all() and np.isfinite(cams).all()):
        return frame_bgr

    kp_px = (joints[:, :2] + 1) * 0.5 * img_size
    cam_full, vert_shifted, kp_original = get_original(proc_param, verts, cams, kp_px)
    if mode == "s":
        out = draw_skeleton(rgb, kp_original)
    elif mode == "m":
        out = renderer(vert_shifted, cam=cam_full, img=rgb)
    elif mode == "r":
        out = renderer.rotated(vert_shifted, 60, cam=cam_full, img_size=rgb.shape[:2])
    else:  # 'b' and any other key: the plain frame
        out = rgb
    out = np.asarray(out)
    if out.dtype != np.uint8:
        out = (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(out, cv2.COLOR_RGB2BGR)


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    import cv2

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--video", default=None, help="video file instead of camera")
    parser.add_argument("--image", default=None, help="single image instead of camera")
    parser.add_argument("--out", default=None, help="write annotated output here")
    args, rest = parser.parse_known_args(argv)
    cfg = parse_config(rest)

    from ..infer.predictor import Predictor

    predictor = Predictor(cfg, batch_size=1, device=device)
    faces = predictor.smpl.faces
    renderer = SMPLRenderer(img_size=cfg.img_size, faces=faces if faces is not None else np.zeros((0, 3), np.int64))

    if args.image is not None:
        frame = cv2.imread(args.image)
        if frame is None:
            raise FileNotFoundError(f"cannot read image {args.image!r}")
        out = annotate_frame(frame, predictor, renderer, cfg.img_size, "m")
        if args.out:
            cv2.imwrite(args.out, out)
        else:
            print(f"annotated frame shape {out.shape}")
        return

    source = args.video if args.video is not None else 0
    vc = cv2.VideoCapture(source)
    if not vc.isOpened():
        raise RuntimeError(f"could not open capture source {source!r}")
    mode = "s"
    writer = None
    try:
        while True:
            rval, frame = vc.read()
            if not rval:
                break
            frame = cv2.rotate(frame, cv2.ROTATE_90_COUNTERCLOCKWISE)
            out = annotate_frame(frame, predictor, renderer, cfg.img_size, mode)
            if args.out:
                if writer is None:
                    writer = cv2.VideoWriter(
                        args.out, cv2.VideoWriter_fourcc(*"mp4v"), 15, (out.shape[1], out.shape[0])
                    )
                writer.write(out)
            else:
                cv2.imshow("preview", out)
                key = cv2.waitKey(1) & 0xFF
                if key == 27:  # ESC
                    break
                if key in (ord("s"), ord("m"), ord("r"), ord("b")):
                    mode = chr(key)
    finally:
        vc.release()
        if writer is not None:
            writer.release()


if __name__ == "__main__":
    main(sys.argv[1:])
