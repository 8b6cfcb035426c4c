"""HMR: ResNet encoder + iterative error feedback (IEF) regression to
SMPL parameters + body model + weak-perspective projection.

Counterpart of ``human_pose_estimation_tpu/models/hmr.py`` (the forward of
``HMR.__call__``). Kept from the reference:

* theta layout [cam(3) | pose(72) | shape(10)];
* rotations returned without the root joint, for the critic;
* ``smpl_stages='last'`` runs the body model on the final stage only
  (the serving path); ``'all'`` on every stage (evaluation).

``encoder_dtype='bfloat16'`` runs the encoder and the regressor under
``torch.autocast``; parameters, BN statistics and the body model stay
f32. The module holds its parameters (as the Flax ``variables`` tree);
the mean theta is passed to ``forward``, as the training state owns it.

Train mode (``HMR.train()``, the JAX ``train=True``): the encoder
normalises with batch statistics and updates its running buffers
(``models/resnet.FlaxBatchNorm2d``), and dropout acts on the LAST IEF
stage only (the reference quirk), with masks from the ``generator``
passed to ``forward``. With ``remat_encoder`` the train-mode encoder
keeps no activations for the backward and recomputes them there
(``torch.utils.checkpoint``); the recompute leaves the BN running
statistics alone, so that they are updated once per step, as JAX's
``jax.checkpoint`` returns them once. Otherwise a train-mode encoder on the
card under grad mode, with no process group, replays its forward and
backward as one CUDA graph pair (``models/encoder_graph.py``, which names
the rules); every other call runs it eagerly.

The int8 serving encoder: ``HMR.quantize_encoder`` folds and quantizes the
encoder's weights once (``models/quantize.py``), and ``forward(...,
encoder_qparams=...)`` runs it in eval mode in place of the float encoder;
the regressor and the body model run as in the float path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import at_least_f32, resolve_device
from ..core.projection import orth_project
from ..core.smpl import SMPLModel, smpl_forward
from ..utils.tracing import span
from . import encoder_graph
from .regressor import IEFRegressor
from .resnet import FlaxBatchNorm2d, ResNet, make_resnet

NUM_CAM = 3
NUM_POSE = 72
NUM_SHAPE = 10

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class StageOutput:
    """Per-IEF-stage outputs (N batch, V verts, J joints). Stages whose
    body model was skipped hold theta/cam/pose/shape only."""

    theta: torch.Tensor  # (N, 85)
    cam: torch.Tensor  # (N, 3)
    pose: torch.Tensor  # (N, 72)
    shape: torch.Tensor  # (N, 10)
    verts: Optional[torch.Tensor] = None  # (N, V, 3)
    joints3d: Optional[torch.Tensor] = None  # (N, J, 3)
    rotations: Optional[torch.Tensor] = None  # (N, 23, 3, 3), root excluded
    kp2d: Optional[torch.Tensor] = None  # (N, J, 2) projected, in [-1, 1]


def split_theta(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[cam | pose | shape] split."""
    return (
        theta[..., :NUM_CAM],
        theta[..., NUM_CAM : NUM_CAM + NUM_POSE],
        theta[..., NUM_CAM + NUM_POSE :],
    )


def _init_encoder(encoder: ResNet, generator: torch.Generator) -> None:
    """Flax's defaults: lecun-normal (truncated) conv kernels, zero biases,
    BN scale 1 / bias 0 / mean 0 / var 1."""
    for m in encoder.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            # the truncated normal's std correction of variance_scaling
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class HMR(nn.Module):
    def __init__(
        self,
        smpl: SMPLModel,
        num_stage: int = 3,
        joint_type: str = "lsp",
        encoder_dtype: str = "float32",
        encoder_stage_sizes=None,
        encoder_depth: int = 50,
        device=None,
        seed: int = 0,
        remat_encoder: bool = False,
    ):
        """Builds the encoder and regressor on ``device`` (``cuda`` unless
        the caller asks for the CPU) with weights from a seeded init; load
        trained or bridged weights with ``load_state_dict``.
        encoder_stage_sizes: a shallow encoder for tests, e.g. (1, 1, 1, 1).
        remat_encoder: recompute the train-mode encoder's activations in
        the backward instead of keeping them (less memory, more time).
        """
        super().__init__()
        if encoder_dtype not in _DTYPES:
            raise ValueError(f"encoder_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        self.num_stage = num_stage
        self.joint_type = joint_type
        self.encoder_dtype = _DTYPES[encoder_dtype]
        self.remat_encoder = remat_encoder
        if encoder_stage_sizes is None:
            self.encoder = make_resnet(encoder_depth)
        else:
            self.encoder = ResNet(tuple(encoder_stage_sizes))
        self.regressor = IEFRegressor(feature_dim=self.encoder.feature_dim)
        gen = torch.Generator().manual_seed(seed)
        _init_encoder(self.encoder, gen)
        self.regressor.reset_parameters(gen)
        self.to(self.device)
        self.eval()

    def _autocast(self):
        return torch.autocast(
            device_type=self.device.type,
            dtype=torch.bfloat16,
            enabled=self.encoder_dtype == torch.bfloat16,
        )

    @contextlib.contextmanager
    def _recompute_context(self):
        """The context of the encoder's recompute in the backward: train
        mode (the caller may have left it by then) with the BN running
        statistics frozen, since the forward already updated them."""
        was = self.encoder.training
        bns = [m for m in self.encoder.modules() if isinstance(m, FlaxBatchNorm2d)]
        self.encoder.train()
        for m in bns:
            m.update_running_stats = False
        try:
            yield
        finally:
            for m in bns:
                m.update_running_stats = True
            self.encoder.train(was)

    @torch.no_grad()
    def quantize_encoder(self, calibration_images: Optional[torch.Tensor] = None):
        """Fold BN into the encoder's convolutions and quantize them to int8
        (post-training), for ``forward(..., encoder_qparams=...)``. With
        ``calibration_images`` ((N, H, W, 3) in [-1, 1], on the module's
        device) the activation scales are calibrated statically, the fast
        path; without them they stay None (per-image dynamic scales)."""
        from .quantize import calibrate_resnet, quantize_resnet

        if getattr(self.encoder, "stem", "standard") != "standard":
            raise ValueError("int8 encoder supports the standard stem only")
        weights = quantize_resnet(
            dict(self.encoder.named_parameters()), dict(self.encoder.named_buffers()), self.encoder.stage_sizes
        )
        act = None
        if calibration_images is not None:
            act = calibrate_resnet(weights, calibration_images, self.encoder.stage_sizes)
        return {"weights": weights, "act": act}

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        with self._autocast():
            return self.encoder(images)

    def forward(
        self,
        images: torch.Tensor,
        mean_theta: torch.Tensor,
        smpl_stages: str = "all",
        encoder_qparams=None,
        generator: Optional[torch.Generator] = None,
    ) -> List[StageOutput]:
        """images (N, H, W, 3) in [-1, 1]; mean_theta (1, 85) initial
        estimate. Returns one StageOutput per IEF stage. In train mode
        ``generator`` (on the module's device) draws the dropout masks of
        the last stage. ``encoder_qparams`` (from ``quantize_encoder``,
        inference only) runs the int8 encoder."""
        if encoder_qparams is not None and self.training:
            raise ValueError("encoder_qparams is an inference-only path")
        if smpl_stages not in ("all", "last"):
            raise ValueError("smpl_stages must be 'all' or 'last'")
        n = images.shape[0]
        with span("model.encoder"):
            if encoder_qparams is not None:
                from .quantize import resnet_apply_int8

                features = resnet_apply_int8(
                    encoder_qparams["weights"], images, self.encoder.stage_sizes, act_scales=encoder_qparams["act"]
                )
            elif self.training and self.remat_encoder:
                # the encoder draws no random numbers, so no RNG state is kept
                features = checkpoint(
                    self._encode,
                    images,
                    use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(), self._recompute_context()),
                )
            elif encoder_graph.bypass(self, images) is None:
                features = encoder_graph.encode(self, images)
            else:
                features = self._encode(images)
        theta = at_least_f32(mean_theta).expand(n, -1)
        stages: List[StageOutput] = []
        for stage in range(self.num_stage):
            last = stage == self.num_stage - 1
            # reference quirk: dropout on the final IEF stage only
            stage_train = self.training and last
            with span("model.ief"), self._autocast():
                delta = self.regressor(features, theta, train=stage_train, generator=generator)
            theta = theta + delta
            cam, pose, shape = split_theta(theta)
            if smpl_stages == "all" or last:
                with span("model.smpl"):
                    out = smpl_forward(self.smpl, shape, pose, joint_type=self.joint_type)
                    kp2d = orth_project(out.joints, cam)
                stages.append(
                    StageOutput(
                        theta=theta,
                        cam=cam,
                        pose=pose,
                        shape=shape,
                        verts=out.verts,
                        joints3d=out.joints,
                        rotations=out.rotations[:, 1:],
                        kp2d=kp2d,
                    )
                )
            else:
                stages.append(StageOutput(theta=theta, cam=cam, pose=pose, shape=shape))
        return stages
