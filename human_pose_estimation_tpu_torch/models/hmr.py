"""HMR: an encoder, a head that regresses SMPL parameters from its
features, the body model and the weak-perspective projection. Two pairs:

* ``backbone='resnet'``, ``head='ief'``: the HMR of the JAX package, a
  ResNet encoder and iterative error feedback (IEF) over an axis-angle Θ;
* ``backbone='vit_h'``, ``head='transformer'``: HMR 2.0's model (Goel et
  al. 2023), the ViTPose-H backbone (``models/vit.py``) and the
  transformer-decoder head (``models/transformer_head.py``), which
  regresses 6D rotations; the body model then takes rotation matrices
  (``core.smpl.smpl_forward(..., rotations=...)``), not axis-angle.

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

HMR 2.0's pair: the ViT sees the middle 3/4 of the columns of each square
crop; in train mode its stochastic-depth masks are drawn from the
``generator`` before its forward (``ViT.draw_masks``, whose docstring and
``models/vit.py``'s give the order) and handed to it, eagerly or into the
encoder's CUDA graph pair, which takes it under the ResNet's rules
(``models/encoder_graph.py``); ``remat_encoder`` and the int8 encoder are
the ResNet's and refuse it. The head runs ``num_stage``
iterations (HMR 2.0's ``IEF_ITERS``), each from the same zero token,
refining the estimate from the mean theta's 6D form; a stage's ``theta``
and ``pose`` are then [cam 3 | 6D pose 144 | shape 10] and the 6D pose,
and its ``rotations`` the 6D map's matrices.
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
from ..core.rotations import rot6d_to_rotmat
from ..core.smpl import SMPLModel, smpl_forward
from ..utils.tracing import span
from . import encoder_graph
from .regressor import IEFRegressor
from .resnet import FlaxBatchNorm2d, ResNet, make_resnet
from .transformer_head import HMR2_HEAD, NUM_JOINTS, HeadShape, TransformerDecoderHead
from .vit import VIT_H, ViT, ViTShape

NUM_CAM = 3
NUM_POSE = 72
NUM_SHAPE = 10

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (backbone, head) pairs the model builds
PAIRS = (("resnet", "ief"), ("vit_h", "transformer"))


@dataclasses.dataclass
class StageOutput:
    """Per-IEF-stage outputs (N batch, V verts, J joints). Stages whose
    body model was skipped hold theta/cam/pose/shape only."""

    theta: torch.Tensor  # (N, 85); (N, 157) with 6D rotations from the transformer head
    cam: torch.Tensor  # (N, 3)
    pose: torch.Tensor  # (N, 72) axis-angle; (N, 144) 6D from the transformer head
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
        backbone: str = "resnet",
        head: str = "ief",
        img_size: int = 224,
        vit_shape: Optional[ViTShape] = None,
        head_shape: Optional[HeadShape] = None,
    ):
        """Builds the encoder and the head on ``device`` (``cuda`` unless the
        caller asks for the CPU) with weights from a seeded init; load
        trained or bridged weights with ``load_state_dict``.
        backbone / head: ``'resnet'`` with ``'ief'`` (the ResNet keys below),
        or ``'vit_h'`` with ``'transformer'`` (HMR 2.0: ``img_size`` the
        square crop, ``vit_shape`` / ``head_shape`` smaller widths for tests,
        ViT-H's and HMR 2.0's by default); these weights are drawn on
        ``device``.
        encoder_stage_sizes: a shallow encoder for tests, e.g. (1, 1, 1, 1).
        remat_encoder: recompute the train-mode encoder's activations in
        the backward instead of keeping them (less memory, more time).
        """
        super().__init__()
        if encoder_dtype not in _DTYPES:
            raise ValueError(f"encoder_dtype must be one of {sorted(_DTYPES)}")
        if (backbone, head) not in PAIRS:
            raise ValueError(f"(backbone, head) must be one of {PAIRS}, got {(backbone, head)}")
        if backbone != "resnet" and remat_encoder:
            raise ValueError("remat_encoder recomputes the ResNet encoder only")
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        self.num_stage = num_stage
        self.joint_type = joint_type
        self.encoder_dtype = _DTYPES[encoder_dtype]
        self.remat_encoder = remat_encoder
        self.backbone, self.head_type = backbone, head
        if backbone == "vit_h":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            with torch.device(self.device):
                self.encoder = ViT(img_size, vit_shape or VIT_H)
                self.head = TransformerDecoderHead(self.encoder.feature_dim, head_shape or HMR2_HEAD)
            self.encoder.reset_parameters(gen)
            self.head.reset_parameters(gen)
        else:
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

    @classmethod
    def from_config(cls, smpl: SMPLModel, cfg, device=None, seed: int = 0, remat_encoder: bool = False) -> "HMR":
        """The model a ``config.Config`` describes: its encoder (``backbone``,
        ``encoder_depth`` or ``encoder_stage_sizes``, ``vit_shape``), head
        (``head``, ``head_shape``), stages, joints, dtype and crop size."""
        ints = lambda s: tuple(int(x) for x in s.split(",")) if s else None  # noqa: E731
        vit_shape, head_shape = ints(cfg.vit_shape), ints(cfg.head_shape)
        return cls(
            smpl,
            num_stage=cfg.num_stage,
            joint_type=cfg.joint_type,
            encoder_dtype=cfg.encoder_dtype,
            encoder_stage_sizes=ints(cfg.encoder_stage_sizes),
            encoder_depth=cfg.encoder_depth,
            device=device,
            seed=seed,
            remat_encoder=remat_encoder,
            backbone=cfg.backbone,
            head=cfg.head,
            img_size=cfg.img_size,
            vit_shape=ViTShape(*vit_shape) if vit_shape else None,
            head_shape=HeadShape(*head_shape) if head_shape else None,
        )

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

        if self.backbone != "resnet":
            raise ValueError("the int8 encoder is the ResNet's; the ViT has none")
        if getattr(self.encoder, "stem", "standard") != "standard":
            raise ValueError("int8 encoder supports the standard stem only")
        weights = quantize_resnet(
            dict(self.encoder.named_parameters()), dict(self.encoder.named_buffers()), self.encoder.stage_sizes
        )
        act = None
        if calibration_images is not None:
            act = calibrate_resnet(weights, calibration_images, self.encoder.stage_sizes)
        return {"weights": weights, "act": act}

    def _encode(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with self._autocast():
            if self.backbone == "vit_h":
                return self.encoder(images, self.encoder.draw_masks(images.shape[0], generator))
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
        estimate. Returns one StageOutput per IEF stage (per head iteration
        of the transformer head). In train mode ``generator`` (on the
        module's device) draws the dropout masks of the last IEF stage, or
        the ViT's stochastic-depth masks. ``encoder_qparams`` (from
        ``quantize_encoder``, inference only) runs the int8 encoder."""
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
                features = encoder_graph.encode(self, images, generator)
            else:
                features = self._encode(images, generator)
        if self.head_type == "transformer":
            return self._decode(features, at_least_f32(mean_theta), smpl_stages)
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

    def _decode(self, context: torch.Tensor, mean_theta: torch.Tensor, smpl_stages: str) -> List[StageOutput]:
        """The transformer head's iterations from the mean theta over the
        ViT's tokens, the body model from the 6D map's matrices."""
        n = context.shape[0]
        stages: List[StageOutput] = []
        for stage in range(self.num_stage):
            last = stage == self.num_stage - 1
            with span("model.head"):
                if stage == 0:
                    estimate = self.head.initial(mean_theta, n)
                with self._autocast():
                    estimate = self.head(context, estimate)
                cam, pose6d, shape = estimate
                rotations = rot6d_to_rotmat(pose6d.reshape(n, NUM_JOINTS, 6))
            theta = torch.cat([cam, pose6d, shape], dim=-1)
            if smpl_stages == "all" or last:
                with span("model.smpl"):
                    out = smpl_forward(self.smpl, shape, None, joint_type=self.joint_type, rotations=rotations)
                    kp2d = orth_project(out.joints, cam)
                stages.append(StageOutput(theta=theta, cam=cam, pose=pose6d, shape=shape, verts=out.verts,
                                          joints3d=out.joints, rotations=out.rotations[:, 1:], kp2d=kp2d))
            else:
                stages.append(StageOutput(theta=theta, cam=cam, pose=pose6d, shape=shape))
        return stages
