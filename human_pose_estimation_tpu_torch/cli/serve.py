"""HTTP model server (counterpart of ``human_pose_estimation_tpu/cli/serve.py``):
a checkpoint, or an exported artifact, behind a REST endpoint.

    python -m human_pose_estimation_tpu_torch.cli.serve \
        --checkpoint_dir ckpt --smpl_model_path models/model.npz \
        --port 8000 [--artifact model.pt2] [--decode_size 224]

POST an encoded image to /predict (an .npz of the SMPL outputs back, or
JSON with Accept: application/json); GET /healthz for liveness and stats.
Concurrent requests are microbatched onto the predictor's batch. Runs on
``cuda``. Decoding a PNG needs nothing more; a JPEG, and ``--decode_size``
(a resize), need OpenCV.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import parse_config


def build_server(argv=None, device=None):
    """Parse the flags, build and warm the predictor (``calibrate=False``:
    the all-zeros warm-up batch never freezes int8 activation scales) and
    the batcher, and build the HTTP server without starting it. Returns
    (server, batcher, args)."""
    from .. import resolve_device

    dev = resolve_device(device)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--artifact", default=None, help="serve an exported artifact instead of a checkpoint")
    p.add_argument("--decode_size", type=int, default=224,
                   help="scale-and-crop uploads to this square size (0 = off)")
    p.add_argument("--max_latency_ms", type=float, default=10.0)
    p.add_argument("--pipeline_depth", type=int, default=1,
                   help="batches kept in flight on the device; 2 overlaps batch assembly and the upload "
                        "with compute")
    p.add_argument("--outputs", default=None,
                   help="restrict response keys, e.g. generated_joints,generated_cams "
                        "(the 6890-vertex mesh dominates response size)")
    p.add_argument("--calibration", default=None,
                   help="image glob for int8 activation-scale calibration (with --encoder_int8 true; "
                        "without it the scales are frozen from the FIRST real request, never the warm-up)")
    args, rest = p.parse_known_args(argv)
    cfg = parse_config(rest)

    from ..infer.http_server import make_server
    from ..infer.serving import BatchingPredictor

    if args.artifact:
        from ..infer.export import ExportedPredictor

        predictor = ExportedPredictor(args.artifact, device=dev)
    else:
        from ..infer.predictor import Predictor

        calib = None
        if args.calibration:
            from ..utils.image import load_calibration_images

            calib = load_calibration_images(args.calibration, cfg.img_size)
        if cfg.encoder_int8 and calib is None:
            print(
                "WARNING: --encoder_int8 without --calibration: static activation scales will be frozen "
                "from the FIRST real request; pass --calibration '<glob>' of representative images for "
                "stable accuracy."
            )
        predictor = Predictor(
            cfg, outputs=tuple(args.outputs.split(",")) if args.outputs else None, calibration_images=calib,
            device=dev,
        )
    # one full padded batch through the real path before the first request
    size = args.decode_size or cfg.img_size
    warm = np.zeros((predictor.batch_size, size, size, 3), np.uint8)
    if args.artifact:
        predictor.predict(warm)
    else:
        predictor.predict(warm, calibrate=False)
    print("warmup done")
    batcher = BatchingPredictor(predictor, max_latency_ms=args.max_latency_ms, pipeline_depth=args.pipeline_depth)
    httpd = make_server(batcher, args.host, args.port, decode_size=args.decode_size or None)
    return httpd, batcher, args


def main(argv=None, device=None) -> None:
    """``device``: ``cuda`` unless the caller asks for the CPU."""
    httpd, batcher, args = build_server(argv, device)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} (batch {batcher.batch_size})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()


if __name__ == "__main__":
    main(sys.argv[1:])
