"""Minimal HTTP serving front end over the BatchingPredictor (counterpart of
``human_pose_estimation_tpu/infer/http_server.py``, the same endpoints,
query parameters and response forms).

Stdlib only (``http.server`` + threading). Endpoints:

  POST /predict   body = encoded PNG or JPEG bytes (``utils.image.decode_image``:
                  8-bit gray / RGB / RGBA PNGs decoded with zlib and numpy,
                  everything else by OpenCV).
                  Response: an .npz archive (generated_verts, generated_cams,
                  generated_joints, theta, kp2d), or JSON (cams, joints and
                  theta) with Accept: application/json. Query parameters:
                    ?format=raw   uncompressed .npz (no zlib pass)
                    ?format=json  JSON body (as the Accept header)
                    ?outputs=generated_joints,generated_cams
                                  restrict the response's keys
                  An unknown format or output key, or an undecodable body,
                  gets a 400 with a JSON error.
  GET  /healthz   liveness and the batcher's stats (requests, batches,
                  padded slots).

Each connection runs on its own thread (ThreadingHTTPServer) and waits
only on its own future; concurrent requests coalesce into device batches
in the BatchingPredictor.
"""
from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.image import decode_image
from .serving import BatchingPredictor

JSON_KEYS = ("generated_cams", "generated_joints", "theta")


def make_server(
    batcher: BatchingPredictor,
    host: str = "127.0.0.1",
    port: int = 8000,
    decode_size: Optional[int] = None,
    request_timeout: float = 120.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; the caller runs serve_forever().

    decode_size: scale and crop uploads on the host to this square size
    (``utils.image.preprocess_for_inference``, OpenCV's resize) so that
    any upload fits the predictor's shape.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, b'{"error": "not found"}', "application/json")
            body = json.dumps({"status": "ok", "batch_size": batcher.batch_size, **batcher.stats}).encode()
            self._send(200, body, "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                return self._send(404, b'{"error": "not found"}', "application/json")
            query = parse_qs(url.query)
            fmt = (query.get("format") or ["npz"])[0]
            keys = (query.get("outputs") or [""])[0]
            try:
                if fmt not in ("npz", "raw", "json"):
                    raise ValueError(f"unknown format {fmt!r} (npz|raw|json)")
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                img = decode_image(raw)
                if decode_size:
                    from ..utils.image import preprocess_for_inference

                    img, _, _ = preprocess_for_inference(img, decode_size)
                    img = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
                result = batcher.submit(img).result(timeout=request_timeout)
                if keys:
                    wanted = [k.strip() for k in keys.split(",") if k.strip()]
                    missing = [k for k in wanted if k not in result]
                    if missing:
                        raise ValueError(f"unknown outputs {missing}; have {sorted(result)}")
                    result = {k: result[k] for k in wanted}
            except Exception as exc:  # the client's error, reported to it
                return self._send(400, json.dumps({"error": str(exc)}).encode(), "application/json")
            if fmt == "json" or "application/json" in (self.headers.get("Accept") or ""):
                json_keys = list(result) if keys else [k for k in JSON_KEYS if k in result]
                body = json.dumps({k: np.asarray(result[k]).tolist() for k in json_keys}).encode()
                return self._send(200, body, "application/json")
            buf = io.BytesIO()
            if fmt == "raw":
                np.savez(buf, **result)
            else:
                np.savez_compressed(buf, **result)
            self._send(200, buf.getvalue(), "application/x-npz")

    return ThreadingHTTPServer((host, port), Handler)


def serve(batcher, host="127.0.0.1", port=8000, decode_size=None, request_timeout=120.0) -> None:
    """Blocking serve loop (Ctrl-C to stop)."""
    httpd = make_server(batcher, host, port, decode_size, request_timeout)
    print(f"serving on http://{host}:{httpd.server_address[1]} (batch {batcher.batch_size})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
