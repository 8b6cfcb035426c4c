"""Serialized serving artifacts through ``torch.export`` (counterpart of
``human_pose_estimation_tpu/infer/export.py``).

``export_predictor`` traces the Predictor's serving graph (normalize,
encoder, 3x IEF, the body model on the last stage, projection) with its
weights, the body model's tensors and, for an int8 predictor, the
quantized weights and activation scales inside, at its batch size. A
serving host loads it with ``ExportedPredictor`` and needs neither the
model code nor the body-model asset nor the checkpoint: only torch.

Artifact layout:
  <path>        a zip archive with one ``torch.export.save`` program per
                platform (``cuda.pt2``, ``cpu.pt2``)
  <path>.json   metadata: encoder_int8, batch, height, width, dtype,
                platforms, outputs, num_stage, joint_type

One program per platform, each traced with the model on that device: a
trace fixes the device of its constants and the device type of the bf16
autocast region, so a CUDA program moved to the CPU would run its encoder
in f32.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

OUTPUT_KEYS = ("generated_verts", "generated_cams", "generated_joints", "theta", "kp2d")


class _ServingGraph(torch.nn.Module):
    """The predictor's serving graph with everything it reads on ``device``."""

    def __init__(self, predictor, device: torch.device):
        super().__init__()
        from .predictor import hmr_on, serving_graph, tree_to

        self.hmr = hmr_on(predictor.hmr, device)
        self.mean_theta = predictor.mean_theta.to(device)
        self.qparams = tree_to(predictor.encoder_qparams, device)
        self.outputs = predictor.outputs
        self._graph = serving_graph

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._graph(self.hmr, images, self.mean_theta, self.qparams, self.outputs)


def export_predictor(
    predictor,
    out_path: str,
    image_hw: Optional[Tuple[int, int]] = None,
    dtype: str = "uint8",
    platforms: Sequence[str] = ("cuda", "cpu"),
) -> Dict:
    """Serialize the predictor's serving graph at its batch size, one
    program per platform in ``platforms`` ('cuda', 'cpu').

    image_hw defaults to (config.img_size, config.img_size); dtype 'uint8'
    exports the serving path that normalizes on the device, 'float32' takes
    images in [-1, 1].
    """
    qp = predictor.encoder_qparams
    if qp is not None and qp["act"] is None:
        raise ValueError(
            "refusing to export an UNCALIBRATED int8 predictor: it would bake the per-image "
            "dynamic-scale graph into the artifact for good, measured slower than not quantizing "
            "(the JAX package's PERF.md). Calibrate first: Predictor(calibration_images=...) or "
            "cli.export_model --calibration '<glob>'."
        )
    h, w = image_hw or (predictor.config.img_size, predictor.config.img_size)
    b = predictor.batch_size
    platforms = [str(p) for p in platforms]
    programs = {}
    for platform in platforms:
        device = resolve_device(platform)
        graph = _ServingGraph(predictor, device).eval()
        example = torch.zeros((b, h, w, 3), dtype=torch.uint8 if dtype == "uint8" else torch.float32, device=device)
        with torch.no_grad():
            program = torch.export.export(graph, (example,))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[platform] = buf.getvalue()
    meta = {
        "encoder_int8": qp is not None,
        "batch": b,
        "height": h,
        "width": w,
        "dtype": dtype,
        "platforms": platforms,
        "outputs": list(predictor.outputs or OUTPUT_KEYS),
        "num_stage": predictor.config.num_stage,
        "joint_type": predictor.config.joint_type,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        for platform, blob in programs.items():
            z.writestr(f"{platform}.pt2", blob)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedPredictor:
    """Serving-side loader of an exported artifact: ``predict`` and
    ``predict_single_image`` as the Predictor's (the same padding to the
    artifact's batch, larger requests cut into batches, the same output
    dict), with no model code, body-model asset or checkpoint: only torch
    and the artifact. device: ``cuda`` unless the caller asks for the CPU;
    it must be one of the artifact's platforms."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with open(path + ".json") as f:
            self.meta = json.load(f)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"the artifact {path!r} holds programs for {self.meta['platforms']}, not {self.device.type!r}"
            )
        with zipfile.ZipFile(path) as z:
            program = torch.export.load(io.BytesIO(z.read(f"{self.device.type}.pt2")))
        self._module = program.module()
        self.batch_size = int(self.meta["batch"])

    def predict(self, images) -> Dict[str, np.ndarray]:
        images = np.asarray(images)
        images = images.astype(np.uint8 if self.meta["dtype"] == "uint8" else np.float32, copy=False)
        n = images.shape[0]
        b = self.batch_size
        if n > b:  # the fixed-batch program, once per batch
            parts = [self.predict(images[s : s + b]) for s in range(0, n, b)]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if n < b:
            images = np.concatenate([images, np.zeros((b - n, *images.shape[1:]), images.dtype)])
        with torch.inference_mode():  # the loaded program's outputs would otherwise require grad
            out = self._module(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
            return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def predict_single_image(self, image) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        res = self.predict(np.asarray(image)[None])
        return res["generated_verts"], res["generated_cams"], res["generated_joints"]
