"""HMR 2.0's ``SMPLTransformerDecoderHead`` (Goel et al., ICCV 2023,
arXiv:2305.20086; ``hmr2/models/heads/smpl_head.py`` and
``hmr2/models/components/pose_transformer.py`` in
github.com/shubham-goel/4D-Humans), the port's own module.

One zero token of width 1 is embedded (Linear(1, width)) and a learned
position (1, 1, width) added; ``depth`` pre-LN layers then refine it, each
``x += self_attn(LN(x))``, ``x += cross_attn(LN(x), context)``,
``x += ff(LN(x))``:

* self-attention: ``heads`` x ``dim_head``, qkv without bias, out
  projection with bias;
* cross-attention to the backbone's tokens (not normalised here): q from
  the token, k and v from the context, both without bias, out projection
  with bias;
* feed-forward: width -> mlp, exact GELU, -> width; dropout 0; LayerNorm
  eps 1e-5 (``nn.LayerNorm``'s default, as published).

Attention runs through ``F.scaled_dot_product_attention`` at scale
1 / sqrt(dim_head). The token is read out by three linear layers,
``decpose`` (24 joints x 6D), ``decshape`` (10) and ``deccam`` (3), each
added to the estimate it refines: the mean on the first iteration.

HMR 2.0's widths: depth 6, width 1024, 8 heads of 64, MLP 1024, context
1280 (ViT-H). The port keeps its 85-d mean theta [cam | axis-angle pose |
shape] as the trained leaf and turns its pose into the 6D form here
(``initial``): the first two columns of each mean rotation.

Beside it, ``HumanPredictionHead``: Multi-HMR's Human Prediction Head
(Baradel et al., ECCV 2024, arXiv:2402.14654, github.com/naver/multi-hmr),
on the whole image's tokens and one query per person slot:

* a per-patch detection logit (``detect``, Linear(width -> 1)) over the
  patch tokens (the class token left out);
* the camera: each patch centre's ray ``((u - c) / f, (v - c) / f)`` under
  the fixed intrinsics (a 60 degree field of view, the principal point at
  the centre), Fourier-embedded (sin and cos at 2^b pi for ``RAY_BANDS``
  bands) and joined to the patch tokens: the context;
* the queries: each slot's context row at its person's centre patch,
  embedded by ``query`` (Linear(context -> width));
* ``depth`` ``DecoderLayer``s: self-attention among the queries of one
  image, with a mask that hides the padded slots (each query still sees
  itself), cross-attention to the image's context, the feed-forward;
* read-outs added to the estimate they refine: ``decpose`` (53 joints x
  6D: the root, 21 body joints, the jaw and 30 finger joints; the two eyes
  stay at identity), ``decshape`` (10 betas), ``decexpr`` (10 expression
  coefficients) and ``deccam`` (the person's 2D offset within its centre
  patch, in patches, and its log-depth against ``DEPTH0``).

The translation is the offset point's ray at the predicted depth, ``z *
K^-1 [u, v, 1]``, and the head projects the body model's points through
the same intrinsics (``project``). Its first estimate comes from the 85-d
mean theta: the SMPL mean's root and 21 body joints, the rest at
identity, its betas, a neutral expression and the offset 0 at ``DEPTH0``.
Widths in the port's configuration: depth 2, width 1024, 8 heads of 64,
MLP 1024, HMR 2.0's decoder layer.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import at_least_f32
from ..core.projection import orth_project, perspective_project
from ..core.rotations import rodrigues, rot6d_to_rotmat, rotmat_to_rot6d
from ..utils.tracing import span

NUM_JOINTS = 24
POSE_6D = 6 * NUM_JOINTS
LN_EPS = 1e-5


class HeadShape(NamedTuple):
    depth: int
    width: int
    heads: int
    dim_head: int
    mlp: int


HMR2_HEAD = HeadShape(depth=6, width=1024, heads=8, dim_head=64, mlp=1024)
MHMR_HEAD = HeadShape(depth=2, width=1024, heads=8, dim_head=64, mlp=1024)

# (cam (N, 3), 6D pose (N, 144), shape (N, 10))
Estimate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, Tq, H*D), (N, Tk, H*D) x2 -> (N, Tq, H*D): multi-head attention;
    ``mask`` (N, 1, Tq, Tk) bool, True where a query may attend."""
    n, tq, inner = q.shape
    split = lambda t: t.reshape(n, t.shape[1], heads, inner // heads).transpose(1, 2)  # noqa: E731
    o = F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=mask)
    return o.transpose(1, 2).reshape(n, tq, inner)


class DecoderLayer(nn.Module):
    def __init__(self, shape: HeadShape, context_dim: int):
        super().__init__()
        inner = shape.heads * shape.dim_head
        self.heads = shape.heads
        self.self_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.self_qkv = nn.Linear(shape.width, 3 * inner, bias=False)
        self.self_out = nn.Linear(inner, shape.width)
        self.cross_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.cross_q = nn.Linear(shape.width, inner, bias=False)
        self.cross_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.cross_out = nn.Linear(inner, shape.width)
        self.ff_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.ff1 = nn.Linear(shape.width, shape.mlp)
        self.ff2 = nn.Linear(shape.mlp, shape.width)

    def forward(self, x: torch.Tensor, context: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, T, width), context (N, Tk, context_dim); ``mask`` (N, 1, T,
        T) bool limits the self-attention (True where a token may attend)."""
        q, k, v = self.self_qkv(self.self_norm(x)).chunk(3, dim=-1)
        x = x + self.self_out(_attend(q, k, v, self.heads, mask))
        k, v = self.cross_kv(context).chunk(2, dim=-1)
        x = x + self.cross_out(_attend(self.cross_q(self.cross_norm(x)), k, v, self.heads))
        return x + self.ff2(F.gelu(self.ff1(self.ff_norm(x))))


class TransformerDecoderHead(nn.Module):
    takes_slots = False  # its rows are the images (``HMR.forward``'s ``slots``)

    def __init__(self, context_dim: int = 1280, shape: HeadShape = HMR2_HEAD):
        super().__init__()
        self.shape = shape
        self.token_embedding = nn.Linear(1, shape.width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, shape.width))
        self.layers = nn.ModuleList([DecoderLayer(shape, context_dim) for _ in range(shape.depth)])
        self.decpose = nn.Linear(shape.width, POSE_6D)
        self.decshape = nn.Linear(shape.width, 10)
        self.deccam = nn.Linear(shape.width, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Drawn from ``generator`` on the module's device: glorot-uniform
        dense layers (the port's regressor initialiser), the published
        ``INIT_DECODER_XAVIER`` read-outs (glorot uniform at gain 0.01, so
        that a fresh head starts at the mean), zero biases, LayerNorm 1 / 0,
        the position as published (standard normal)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                gain = 0.01 if m in (self.decpose, self.decshape, self.deccam) else 1.0
                nn.init.xavier_uniform_(m.weight, gain=gain, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.pos_embedding, generator=generator)

    @staticmethod
    def initial(mean_theta: torch.Tensor, n: int) -> Estimate:
        """The first estimate from the (1, 85) mean theta: (cam, its pose's
        rotations in 6D, shape), each expanded to ``n`` rows."""
        cam, pose, shape = mean_theta[:, :3], mean_theta[:, 3:75], mean_theta[:, 75:]
        pose6d = rotmat_to_rot6d(rodrigues(pose.reshape(-1, NUM_JOINTS, 3))).reshape(-1, POSE_6D)
        return cam.expand(n, -1), pose6d.expand(n, -1), shape.expand(n, -1)

    def forward(self, context: torch.Tensor, estimate: Estimate) -> Estimate:
        """context (N, tokens, context_dim); ``estimate`` (cam, pose6d,
        shape) -> the refined estimate."""
        cam, pose6d, shape = estimate
        token = context.new_zeros(context.shape[0], 1, 1)
        x = self.token_embedding(token) + self.pos_embedding
        for layer in self.layers:
            x = layer(x, context)
        x = x[:, 0]
        return self.deccam(x) + cam, self.decpose(x) + pose6d, self.decshape(x) + shape

    project = staticmethod(orth_project)

    def step(self, context, estimate, first, last, generator, autocast, slots=None):
        """One iteration from ``estimate`` (the mean theta on the ``first``,
        made ``initial`` inside the span): (the refined estimate, the
        stage's theta, cam, 6D pose and shape, the body model's pose: the 6D
        map's matrices). ``autocast()`` covers the decoder alone; the head
        draws nothing and takes no person slots."""
        n = context.shape[0]
        with span("model.head"):
            if first:
                estimate = self.initial(estimate, n)
            with autocast():
                estimate = self(context, estimate)
            cam, pose6d, shape = estimate
            rotations = rot6d_to_rotmat(pose6d.reshape(n, NUM_JOINTS, 6))
        theta = torch.cat([cam, pose6d, shape], dim=-1)
        return estimate, dict(theta=theta, cam=cam, pose=pose6d, shape=shape), {"theta": None, "rotations": rotations}


REGRESSED = 53  # SMPL-X's joints but the two eyes
EXPRESSION = 10  # SMPL-X's expression coefficients
EYES = 23  # the first eye's joint; the second follows
FOV_DEG = 60.0
RAY_BANDS = 8
DEPTH0 = 5.0  # the depth (in the body model's units) a fresh head starts from

# (cam (N, 3) [offset x, offset y, log-depth], 6D pose (N, 318), betas (N, 10), expression (N, 10))
SlotEstimate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class HumanPredictionHead(nn.Module):
    """Multi-HMR's HPH (the module docstring): (B, 1 + patches, width)
    tokens and (B, K) person slots -> per slot SMPL-X parameters and a
    translation, and a detection logit per patch."""

    takes_slots = True  # its rows are the person slots, image by image

    def __init__(self, context_dim: int = 1024, shape: HeadShape = MHMR_HEAD, img_size: int = 896, patch: int = 14):
        super().__init__()
        self.shape = shape
        self.img_size, self.patch, self.grid = img_size, patch, img_size // patch
        self.focal = 0.5 * img_size / math.tan(math.radians(FOV_DEG / 2))
        self.principal = 0.5 * img_size
        ctx = context_dim + 4 * RAY_BANDS
        self.detect = nn.Linear(context_dim, 1)
        self.query = nn.Linear(ctx, shape.width)
        self.layers = nn.ModuleList([DecoderLayer(shape, ctx) for _ in range(shape.depth)])
        self.decpose = nn.Linear(shape.width, 6 * REGRESSED)
        self.decshape = nn.Linear(shape.width, 10)
        self.decexpr = nn.Linear(shape.width, EXPRESSION)
        self.deccam = nn.Linear(shape.width, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``TransformerDecoderHead``'s initialiser: glorot-uniform dense
        layers, the four read-outs at gain 0.01, zero biases, LayerNorm 1 /
        0."""
        outs = (self.decpose, self.decshape, self.decexpr, self.deccam)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, gain=0.01 if m in outs else 1.0, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def initial(self, mean_theta: torch.Tensor, n: int) -> SlotEstimate:
        """The first estimate from the (1, 85) mean theta, on ``n`` rows: the
        offset 0 at ``DEPTH0``, the SMPL mean's root and 21 body joints and
        the other 31 regressed joints at identity in 6D, its betas, a neutral
        expression."""
        body = mean_theta[:, 3:69].reshape(1, 22, 3)
        pose = torch.cat([body, body.new_zeros(1, REGRESSED - 22, 3)], dim=1)
        pose6d = rotmat_to_rot6d(rodrigues(pose)).reshape(1, 6 * REGRESSED)
        zero = mean_theta.new_zeros(1, 3)
        expr = mean_theta.new_zeros(1, EXPRESSION)
        return tuple(t.expand(n, -1) for t in (zero, pose6d, mean_theta[:, 75:85], expr))

    def rays(self, device) -> torch.Tensor:
        """(patches, 4 RAY_BANDS): the Fourier embedding of each patch
        centre's ray, row by row."""
        centre = (torch.arange(self.grid, device=device, dtype=torch.float32) + 0.5) * self.patch
        r = (centre - self.principal) / self.focal
        ray = torch.stack(torch.meshgrid(r, r, indexing="xy"), dim=-1).reshape(-1, 2)  # (x, y)
        a = ray[..., None] * (math.pi * 2.0 ** torch.arange(RAY_BANDS, device=device, dtype=torch.float32))
        return torch.cat([torch.sin(a), torch.cos(a)], dim=-1).reshape(-1, 4 * RAY_BANDS)

    def patches(self, centers: torch.Tensor) -> torch.Tensor:
        """(..., 2) centres [x, y] in pixels -> (...) int64 indices of the
        patches that hold them, row by row (clamped to the grid)."""
        cell = torch.floor(centers / self.patch).long().clamp(0, self.grid - 1)
        return cell[..., 1] * self.grid + cell[..., 0]

    def translation(self, cam: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """(N, 3) translations from cam (N, 3) and the slots' centre patches
        (N,): the offset point's ray at the depth ``DEPTH0 * exp(cam[2])``."""
        col, row = centers % self.grid, torch.div(centers, self.grid, rounding_mode="floor")
        u = (col.to(cam.dtype) + 0.5 + cam[:, 0]) * self.patch
        v = (row.to(cam.dtype) + 0.5 + cam[:, 1]) * self.patch
        z = DEPTH0 * torch.exp(cam[:, 2])
        return torch.stack([z * (u - self.principal) / self.focal, z * (v - self.principal) / self.focal, z], -1)

    def project(self, points: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
        """(N, P, 3) body points and (N, 3) translations -> (N, P, 2) in the
        [-1, 1] image frame, through the head's intrinsics."""
        px = perspective_project(points, translation, self.focal, self.principal)
        return px * (2.0 / self.img_size) - 1.0

    def step(self, context, estimate, first, last, generator, autocast, slots=None):
        """The head over ``context`` (B, 1 + patches, width) and ``slots`` =
        (each person's centre (B, K, 2) in pixels, valid (B, K)), from
        ``estimate`` (the mean theta on the ``first``): (the refined
        estimate, the stage's per-slot theta [cam | 6D pose | betas |
        expression], translation, 6D pose and betas, the images' detection
        logits (B, patches) and the slots' centre patches (B, K), the body
        model's pose: SMPL-X's 55 matrices, and its beta: the betas and the
        expression). Rows are slots, image by image. ``autocast()`` covers
        the networks; the head draws nothing."""
        centers, valid = slots
        b, k = centers.shape[:2]
        n = b * k
        with span("model.head"):
            tokens = context[:, context.shape[1] - self.grid * self.grid :]
            if first:
                estimate = self.initial(estimate, n)
            with span("model.camera"):
                rays = self.rays(tokens.device).to(tokens.dtype).expand(b, -1, -1)
            ctx = torch.cat([tokens, rays], dim=-1)
            with span("model.queries"):
                patches = self.patches(centers)
                q = ctx.gather(1, patches[..., None].expand(-1, -1, ctx.shape[-1]))
            eye = torch.eye(k, dtype=torch.bool, device=valid.device)
            mask = ((valid > 0)[:, None, :] | eye)[:, None]  # (B, 1, K, K): valid keys, and itself
            with autocast():
                detection = self.detect(tokens)[..., 0]
                x = self.query(q)
                for layer in self.layers:
                    x = layer(x, ctx, mask)
                x = x.reshape(n, -1)
                deltas = (self.deccam(x), self.decpose(x), self.decshape(x), self.decexpr(x))
            estimate = tuple(d + e for d, e in zip(deltas, estimate))
            cam, pose6d, betas, expr = estimate
            rot = rot6d_to_rotmat(pose6d.reshape(n, REGRESSED, 6))
            eyes = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(n, 2, 3, 3)
            rotations = torch.cat([rot[:, :EYES], eyes, rot[:, EYES:]], dim=1)
            translation = self.translation(cam, patches.reshape(n))
        theta = torch.cat([cam, pose6d, betas, expr], dim=-1)
        stage = dict(theta=theta, cam=translation, pose=pose6d, shape=betas, detection=at_least_f32(detection),
                     patches=patches)
        return estimate, stage, {"theta": None, "rotations": rotations, "beta": torch.cat([betas, expr], dim=-1)}
