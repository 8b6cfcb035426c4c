"""HMR: an encoder, a head that regresses body-model parameters from its
features, the body model and the head's camera projection. Three pairs,
each built by its entry of ``FAMILIES``:

* ``backbone='resnet'``, ``head='ief'``: the HMR of the JAX package, a
  ResNet encoder and iterative error feedback (IEF) over an axis-angle Θ;
* ``backbone='vit_h'``, ``head='transformer'``: HMR 2.0's model (Goel et
  al. 2023), the ViTPose-H backbone (``models/vit.py``) and the
  transformer-decoder head (``models/transformer_head.py``), which
  regresses 6D rotations; the body model then takes rotation matrices
  (``core.smpl``'s ``rotations``), not axis-angle;
* ``backbone='dinov2_l14'``, ``head='hph'``: Multi-HMR's model (Baradel et
  al. 2024), DINOv2's ViT-L/14 over the whole image (``models/vit.py``'s
  ``DINOV2`` options) and the Human Prediction Head
  (``models/transformer_head.HumanPredictionHead``): one query per person
  slot, SMPL-X's 6D rotations, betas and expression, a perspective
  translation, and a detection logit per patch. Its rows are the person
  slots, image by image, and ``forward`` takes the slots: each one's
  centre patch and whether a person fills it.

Counterpart of ``human_pose_estimation_tpu/models/hmr.py`` (the forward of
``HMR.__call__``). Kept from the reference:

* theta layout [cam(3) | pose(72) | shape(10)];
* rotations returned without the root joint, for the critic;
* ``smpl_stages='last'`` runs the body model on the final stage only
  (the serving path); ``'all'`` on every stage (evaluation).

The seam between ``HMR`` and what it composes: every encoder has
``draw_masks(n, generator)``, the random numbers of its train-mode forward
drawn up front (None where it draws none: the ResNet, any eval mode), and
``forward(images, masks)``; every head has ``initial(mean_theta, n)``, its
first estimate, ``step``, one stage (the next estimate, the stage's
fields: theta, cam, pose, shape and any the head adds, and the pose, and
where it differs from the stage's shape the beta, that the body model
takes), and ``project(points, cam)``, its camera into the [-1, 1] image
frame. The person slots, where ``forward`` is given them, go to the head.
``forward`` draws the masks, runs the encoder, then ``num_stage`` head
steps, with the body model on the stages that ``smpl_stages`` asks for.

``encoder_dtype='bfloat16'`` runs the encoder and the head's network under
``torch.autocast``; parameters, BN statistics and the body model stay
f32. The module holds its parameters (as the Flax ``variables`` tree);
the mean theta is passed to ``forward``, as the training state owns it.

Train mode (``HMR.train()``, the JAX ``train=True``): the ResNet
normalises with batch statistics and updates its running buffers, the ViT
drops blocks, and IEF's dropout acts on its LAST stage only (the reference
quirk), each draw from the ``generator`` passed to ``forward``. With ``remat_encoder`` the
train-mode ResNet keeps no activations for the backward and recomputes
them there (``torch.utils.checkpoint``) under ``ResNet.recomputing``,
which leaves the BN running statistics alone, so that they are updated
once per step, as JAX's ``jax.checkpoint`` returns them once. Otherwise a
train-mode encoder on the card under grad mode, with no process group,
replays its forward and backward as one CUDA graph pair
(``models/encoder_graph.py``, which names the rules); every other call
runs it eagerly. The body model takes its own graphs under grad mode on the
card, one capture a stage (``models/body_graph.py``, the stage index its
slot); evaluation, serving and the CPU run it eagerly.

The int8 serving encoder: ``HMR.quantize_encoder`` folds and quantizes the
ResNet's weights once (``models/quantize.py``), and ``forward(...,
encoder_qparams=...)`` runs it in eval mode in place of the float encoder.
``remat_encoder`` and the int8 encoder refuse the ViTs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import at_least_f32, resolve_device
from ..core.smpl import SMPLModel
from ..utils.tracing import span
from . import body_graph, encoder_graph
from .regressor import IEFRegressor
from .resnet import ResNet, make_resnet
from .transformer_head import HMR2_HEAD, MHMR_HEAD, HeadShape, HumanPredictionHead, TransformerDecoderHead
from .vit import DINOV2, VIT_H, VIT_L, ViT, ViTShape

NUM_CAM = 3
NUM_POSE = 72
NUM_SHAPE = 10

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    rotations: Optional[torch.Tensor] = None  # (N, 23, 3, 3), root excluded (N, 54, 3, 3) for SMPL-X
    kp2d: Optional[torch.Tensor] = None  # (N, J, 2) projected, in [-1, 1]
    detection: Optional[torch.Tensor] = None  # (B, patches) per-patch person logits (the HPH)
    patches: Optional[torch.Tensor] = None  # (B, K) the slots' centre patches (the HPH)


def split_theta(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[cam | pose | shape] split."""
    return (
        theta[..., :NUM_CAM],
        theta[..., NUM_CAM : NUM_CAM + NUM_POSE],
        theta[..., NUM_CAM + NUM_POSE :],
    )


def _resnet_ief(device, seed, encoder_depth, encoder_stage_sizes, **_):
    """The ResNet and IEF, drawn from a CPU generator (``HMR`` moves them)."""
    encoder = make_resnet(encoder_depth) if encoder_stage_sizes is None else ResNet(tuple(encoder_stage_sizes))
    regressor = IEFRegressor(feature_dim=encoder.feature_dim)
    gen = torch.Generator().manual_seed(seed)
    encoder.reset_parameters(gen)
    regressor.reset_parameters(gen)
    return encoder, "regressor", regressor


def _vit_transformer(device, seed, img_size, vit_shape, head_shape, **_):
    """HMR 2.0's ViT and transformer head, built and drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        encoder = ViT(img_size, vit_shape or VIT_H)
        head = TransformerDecoderHead(encoder.feature_dim, head_shape or HMR2_HEAD)
    encoder.reset_parameters(gen)
    head.reset_parameters(gen)
    return encoder, "head", head


def _dinov2_hph(device, seed, img_size, vit_shape, head_shape, **_):
    """Multi-HMR's DINOv2 ViT-L/14 and Human Prediction Head, built and
    drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        encoder = ViT(img_size, vit_shape or VIT_L, DINOV2)
        head = HumanPredictionHead(encoder.feature_dim, head_shape or MHMR_HEAD, img_size, DINOV2.patch)
    encoder.reset_parameters(gen)
    head.reset_parameters(gen)
    return encoder, "head", head


# (backbone, head) -> the builder of (encoder, the head's attribute: its state-dict prefix, head)
FAMILIES = {("resnet", "ief"): _resnet_ief, ("vit_h", "transformer"): _vit_transformer,
            ("dinov2_l14", "hph"): _dinov2_hph}
PAIRS = tuple(FAMILIES)


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
        if (backbone, head) not in FAMILIES:
            raise ValueError(f"(backbone, head) must be one of {PAIRS}, got {(backbone, head)}")
        self.pair = (backbone, head)
        self.device = resolve_device(device)
        self.smpl = smpl.to(self.device)
        self.num_stage = num_stage
        self.joint_type = joint_type
        self.encoder_dtype = _DTYPES[encoder_dtype]
        self.remat_encoder = remat_encoder
        self.encoder, self._head, stage_head = FAMILIES[(backbone, head)](
            self.device, seed, encoder_depth=encoder_depth, encoder_stage_sizes=encoder_stage_sizes,
            img_size=img_size, vit_shape=vit_shape, head_shape=head_shape)
        self.add_module(self._head, stage_head)
        if remat_encoder and not isinstance(self.encoder, ResNet):
            raise ValueError("remat_encoder recomputes the ResNet encoder only")
        self.to(self.device)
        self.eval()

    def describe(self) -> str:
        """The model as its weights must fit it: the pair, the encoder's
        widths and the head's, for a message."""
        encoder = self.encoder
        widths = (f"stage sizes {encoder.stage_sizes}" if isinstance(encoder, ResNet)
                  else f"{tuple(encoder.shape)} at {encoder.num_tokens} tokens")
        head = getattr(self, self._head)
        head_widths = f", head {tuple(head.shape)}" if hasattr(head, "shape") else ""
        return f"(backbone, head) = {self.pair}, encoder {widths}{head_widths}"

    def project(self, points: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """(N, P, 3) body points and a stage's (N, 3) cam -> (N, P, 2) in
        the [-1, 1] image frame, by the head's camera."""
        return getattr(self, self._head).project(points, cam)

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

    @torch.no_grad()
    def quantize_encoder(self, calibration_images: Optional[torch.Tensor] = None):
        """Fold BN into the encoder's convolutions and quantize them to int8
        (post-training), for ``forward(..., encoder_qparams=...)``. With
        ``calibration_images`` ((N, H, W, 3) in [-1, 1], on the module's
        device) the activation scales are calibrated statically, the fast
        path; without them they stay None (per-image dynamic scales)."""
        from .quantize import calibrate_resnet, quantize_resnet

        if not isinstance(self.encoder, ResNet):
            raise ValueError("the int8 encoder is the ResNet's; the ViT has none")
        if self.encoder.stem != "standard":
            raise ValueError("int8 encoder supports the standard stem only")
        weights = quantize_resnet(
            dict(self.encoder.named_parameters()), dict(self.encoder.named_buffers()), self.encoder.stage_sizes
        )
        act = None
        if calibration_images is not None:
            act = calibrate_resnet(weights, calibration_images, self.encoder.stage_sizes)
        return {"weights": weights, "act": act}

    def _encode(self, images: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
        with self._autocast():
            return self.encoder(images, masks)

    def forward(
        self,
        images: torch.Tensor,
        mean_theta: torch.Tensor,
        smpl_stages: str = "all",
        encoder_qparams=None,
        generator: Optional[torch.Generator] = None,
        slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> List[StageOutput]:
        """images (N, H, W, 3) in [-1, 1]; mean_theta (1, 85) initial
        estimate. Returns one StageOutput per IEF stage (per head iteration
        of the transformer head). In train mode ``generator`` (on the
        module's device) draws the ViT's stochastic-depth masks, then the
        dropout masks of the last IEF stage. ``encoder_qparams`` (from
        ``quantize_encoder``, inference only) runs the int8 encoder.
        ``slots`` = (each person's centre (N, K, 2) in pixels, valid (N,
        K)): the person slots of a head that takes them (the HPH, its
        ``takes_slots``), whose stage rows are then the N x K slots; every
        other head refuses them."""
        head = getattr(self, self._head)
        if (slots is not None) != head.takes_slots:
            raise ValueError(f"{self.describe()}: the head takes {'' if head.takes_slots else 'no '}person slots")
        if encoder_qparams is not None and self.training:
            raise ValueError("encoder_qparams is an inference-only path")
        if smpl_stages not in ("all", "last"):
            raise ValueError("smpl_stages must be 'all' or 'last'")
        with span("model.encoder"):
            masks = self.encoder.draw_masks(images.shape[0], generator)
            if encoder_qparams is not None:
                from .quantize import resnet_apply_int8

                features = resnet_apply_int8(
                    encoder_qparams["weights"], images, self.encoder.stage_sizes, act_scales=encoder_qparams["act"]
                )
            elif self.training and self.remat_encoder:
                # the masks are drawn up front, so no RNG state is kept
                features = checkpoint(
                    self._encode,
                    images,
                    masks,
                    use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(), self.encoder.recomputing()),
                )
            elif encoder_graph.bypass(self, images) is None:
                features = encoder_graph.encode(self, images, masks)
            else:
                features = self._encode(images, masks)
        estimate = at_least_f32(mean_theta)
        stages: List[StageOutput] = []
        for stage in range(self.num_stage):
            last = stage == self.num_stage - 1
            estimate, fields, body_pose = head.step(
                features, estimate, stage == 0, last, generator, self._autocast, slots
            )
            out = StageOutput(**fields)
            if smpl_stages == "all" or last:
                with span("model.smpl"):
                    beta = body_pose.pop("beta", out.shape)
                    body = body_graph.forward(stage, self.smpl, beta, joint_type=self.joint_type,
                                              int8=encoder_qparams is not None, **body_pose)
                    out.kp2d = head.project(body.joints, out.cam)
                out.verts, out.joints3d, out.rotations = body.verts, body.joints, body.rotations[:, 1:]
            stages.append(out)
        return stages
