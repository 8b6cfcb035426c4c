"""Inference: batched HMR prediction (counterpart of
``human_pose_estimation_tpu/infer/predictor.py``).

Pads partial batches to a fixed batch size, ships uint8 images to the
device (4x less host->device traffic than f32) and normalizes them there,
runs encoder -> 3x IEF -> SMPL on the last stage, and returns the wanted
outputs. Without explicit weights it restores them from
``config.checkpoint_dir`` (``utils/checkpoint.restore_for_inference``: this
package's checkpoints or the JAX package's).

``encoder_int8`` serves with the post-training int8 encoder
(``models/quantize.py``): the weights are folded and quantized once here;
the activation scales are calibrated on ``calibration_images`` when given,
else on the first real batch served (its unpadded rows), never on a warm-up
call (``calibrate=False``).

``data_parallel`` serves over several local devices, one replica of the
model on each: the padded batch is split evenly over them, in order, and
the results are concatenated in the same order.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..core.smpl import load_model
from ..models.hmr import HMR


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 images to [-1, 1] in f32; float images pass as they are."""
    if images.dtype == torch.uint8:
        return images.float() / 127.5 - 1.0
    return images


def serving_graph(hmr: HMR, images: torch.Tensor, mean_theta: torch.Tensor, qparams=None,
                  outputs: Optional[Tuple[str, ...]] = None) -> Dict[str, torch.Tensor]:
    """The serving forward (the graph ``infer/export.py`` traces): normalize,
    encoder (int8 with ``qparams``) -> IEF -> body model on the last stage,
    and the wanted outputs."""
    last = hmr(normalize(images), mean_theta, smpl_stages="last", encoder_qparams=qparams)[-1]
    out = {
        "generated_verts": last.verts,
        "generated_cams": last.cam,
        "generated_joints": last.joints3d,
        "theta": last.theta,
        "kp2d": last.kp2d,
    }
    if outputs is not None:
        out = {k: out[k] for k in outputs}
    return out


def tree_to(tree, device):
    """A tensor, or a dict tree of them (int8 parameters), on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def hmr_on(hmr: HMR, device) -> HMR:
    """``hmr`` when it lives on ``device``, else a copy moved there (weights,
    buffers and body model)."""
    device = torch.device(device)
    if _canonical(hmr.device) == _canonical(device):
        return hmr
    replica = copy.deepcopy(hmr).to(device)
    replica.smpl, replica.device = hmr.smpl.to(device), device
    return replica


class Predictor:
    """Serves (verts, cams, joints, theta, kp2d) for image batches."""

    def __init__(
        self,
        config: Config,
        smpl=None,
        variables=None,
        mean_theta=None,
        batch_size: Optional[int] = None,
        data_parallel: bool = False,
        outputs: Optional[Tuple[str, ...]] = None,
        encoder_int8: bool = False,
        calibration_images=None,
        device=None,
    ):
        """variables: the state dict of models.hmr.HMR (from training, or
        from the JAX package through models/port_jax.py); mean_theta: the
        (1, 85) initial estimate. encoder_int8 (or ``config.encoder_int8``):
        serve the int8 encoder, calibrated on ``calibration_images`` ((N, H,
        W, 3), uint8 or float in [-1, 1]) when given, else lazily on the first
        real batch. data_parallel: one replica per device of
        ``parallel.mesh.make_mesh`` (every CUDA device, trimmed to the
        largest count that divides the batch; the CPU is one device), each
        serving its equal slice of the padded batch. Without variables and mean_theta, both are restored from
        ``config.checkpoint_dir`` (fresh from ``config.seed`` when it holds
        no checkpoint). The model is the one ``config`` describes
        (``HMR.from_config``: the ResNet of ``encoder_depth``, or of
        ``encoder_stage_sizes`` when set, or HMR 2.0's ViT and head); weights
        of another shape are refused. outputs: restrict the returned keys.
        device: ``cuda`` unless the caller asks for the CPU."""
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.outputs = tuple(outputs) if outputs else None
        self.smpl = smpl if smpl is not None else load_model(config.smpl_model_path)
        self.hmr = HMR.from_config(self.smpl, config, device=device, seed=config.seed)
        source = "the given variables"
        if variables is None or mean_theta is None:
            from ..utils.checkpoint import restore_for_inference

            variables, mean_theta = restore_for_inference(config.checkpoint_dir, self.hmr, config)
            source = f"the checkpoint under {config.checkpoint_dir!r}"
        try:
            self.hmr.load_state_dict(variables)
        except RuntimeError as e:
            if config.backbone != "resnet":
                encoder = f"backbone={config.backbone!r}, vit_shape={config.vit_shape!r}"
            elif config.encoder_stage_sizes:
                encoder = f"encoder_stage_sizes={config.encoder_stage_sizes!r}"
            else:
                encoder = f"encoder_depth={config.encoder_depth}"
            raise RuntimeError(
                f"the weights of {source} do not fit the configured encoder ({encoder}): {e}"
            ) from e
        self.device = self.hmr.device
        self.mean_theta = torch.as_tensor(mean_theta, dtype=torch.float32).reshape(1, -1).to(self.device)
        self.encoder_qparams = None
        if encoder_int8 or config.encoder_int8:
            calib = None
            if calibration_images is not None:
                calib = torch.as_tensor(np.asarray(calibration_images)).to(self.device)
                calib = normalize(calib if calib.dtype == torch.uint8 else calib.float())
            self.encoder_qparams = self.hmr.quantize_encoder(calibration_images=calib)
        # (hmr, mean_theta, device) per replica, in batch order
        self.replicas = [(self.hmr, self.mean_theta, self.device)]
        if data_parallel:
            from ..parallel.mesh import make_mesh

            local = None if self.device.type == "cuda" else [self.device]
            self.replicas = [
                (hmr_on(self.hmr, d), self.mean_theta.to(d), d) for d in make_mesh(local, self.batch_size)
            ]

    @torch.inference_mode()
    def _predict_impl(self, images: torch.Tensor, qparams=None, replica=0) -> Dict[str, torch.Tensor]:
        hmr, mean_theta, device = self.replicas[replica]
        if replica:
            qparams = tree_to(qparams, device)
        return serving_graph(hmr, images, mean_theta, qparams, self.outputs)

    def predict_async(self, images, calibrate: bool = True):
        """Enqueue ONE padded batch (N <= batch_size) on the device without
        waiting; returns a handle for ``predict_fetch``. CUDA work is
        asynchronous, so the caller can prepare the next batch meanwhile.

        An int8 predictor without activation scales calibrates them on this
        batch's unpadded rows and keeps them; ``calibrate=False`` marks a
        warm-up call, which runs the same static-scale path on one-off
        scales from the whole batch and keeps none (nor does an empty
        request)."""
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        n = images.shape[0]
        b = self.batch_size
        if n > b:
            raise ValueError(f"predict_async takes at most the batch size ({b}); got {n}")
        if n < b:
            images = np.concatenate(
                [images, np.zeros((b - n, *images.shape[1:]), images.dtype)], axis=0
            )
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            host = host.pin_memory()
        # one equal slice of the padded batch per replica, in order
        parts = [
            c.to(d, non_blocking=True) for c, (_, _, d) in zip(host.chunk(len(self.replicas)), self.replicas)
        ]
        qp = self.encoder_qparams
        if qp is not None and qp["act"] is None:
            from ..models.quantize import calibrate_resnet

            device_images = parts[0] if len(parts) == 1 else torch.cat([p.to(self.device) for p in parts])
            freeze = calibrate and n > 0
            rows = device_images[:n] if freeze else device_images
            act = calibrate_resnet(qp["weights"], normalize(rows), self.hmr.encoder.stage_sizes)
            qp = {"weights": qp["weights"], "act": act}
            if freeze:
                self.encoder_qparams = qp
        return [self._predict_impl(x, qp, i) for i, x in enumerate(parts)], n

    def predict_fetch(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a ``predict_async`` handle; numpy outputs for its N rows
        (the replicas' results concatenated in batch order)."""
        outs, n = handle
        if len(outs) == 1:
            return {k: v[:n].cpu().numpy() for k, v in outs[0].items()}
        return {k: torch.cat([o[k].cpu() for o in outs])[:n].numpy() for k in outs[0]}

    def predict(self, images, calibrate: bool = True) -> Dict[str, np.ndarray]:
        """Predict on a (N, H, W, 3) batch — float in [-1, 1], or uint8
        (normalized on the device). Pads N up to the batch size; larger
        requests are cut into batches, all enqueued before any is fetched.
        calibrate=False: a warm-up call, which never keeps lazy int8
        activation scales (``predict_async``)."""
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        n = images.shape[0]
        b = self.batch_size
        handles = [self.predict_async(images[s : s + b], calibrate) for s in range(0, n, b)] or [
            self.predict_async(images, calibrate)  # n == 0
        ]
        parts = [self.predict_fetch(h) for h in handles]
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def predict_single_image(self, image) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(verts, cams, joints) for one (H, W, 3) image."""
        res = self.predict(np.asarray(image)[None])
        return res["generated_verts"], res["generated_cams"], res["generated_joints"]
