"""The plain reference of Multi-HMR's model (Baradel et al., "Multi-HMR:
Multi-Person Whole-Body Human Mesh Recovery in a Single Shot", ECCV 2024,
arXiv:2402.14654; github.com/naver/multi-hmr, checkpoint multiHMR_896_L)
and of the hybrid training step on it, with person slots.

Written from the published description in functional form over a dict of
tensors named as the state dict that the benchmark loads into the system
under test; it imports nothing of the system under test. Every function
computes in the dtype of its parameters; the benchmark runs it in float32
with TF32 off.

* **The ViT** (DINOv2's ViT-L/14): the whole square image; the patch
  embedding Conv2d(3 -> width, kernel 14, stride 14, no padding); a class
  token before the patches; the learned position (1, 1 + 37^2, width)
  stored on a 37 x 37 grid, its patch part resized bicubically (no corner
  alignment) to the image's grid and added to the patches, its first row
  added to the class token; ``depth`` pre-LN blocks ``x += g1 *
  attn(LN(x))``, ``x += g2 * mlp(LN(x))`` (LayerScale g1, g2 per channel)
  with biased qkv and out projections, softmax(q k^T / sqrt(d)) v per
  head, the MLP width -> mlp, exact GELU, -> width, LayerNorm eps 1e-6; a
  final LayerNorm. No stochastic depth.
* **The Human Prediction Head**: a per-patch detection logit (a dense
  layer on each patch token); the context, each patch token joined to the
  Fourier embedding (sin and cos at 2^b pi, ``ray_bands`` bands) of its
  centre's ray ((u - c) / f, (v - c) / f) under fixed intrinsics (a 60
  degree field of view, the principal point at the centre); one query per
  person slot, the context row at the patch that holds the person's
  centre, embedded by a dense layer; ``depth`` pre-LN decoder layers
  (HMR 2.0's: self-attention among the queries of one image, a padded
  slot hidden from the others but seen by itself, cross-attention to the
  image's context, the feed-forward, LayerNorm eps 1e-5); read-outs of 53
  joints' 6D rotations, 10 betas, 10 expression coefficients and the
  camera (the 2D offset in the centre patch, in patches, and the
  log-depth against ``DEPTH0``), each added to the estimate it refines.
  The first estimate: the offset 0 at depth ``DEPTH0``, the 85-d mean
  theta's root and 21 body joints (the other 31 at identity), its betas, a
  neutral expression. The translation: ``z K^-1 [u, v, 1]`` at the offset
  point (u, v) and depth z.
* **SMPL-X**: 55 joints (``PARENTS``), the two eyes held at identity; the
  shape and the expression blend shapes, the pose blend shapes of the 54
  non-root joints, the kinematic chain, linear blend skinning, the keypoint
  regressor; the perspective projection through the head's intrinsics.

The step (``train_step``) is the repository's hybrid step on person slots:
the input path on whole images (``prepare``: the crop around the image's
centre, jittered, every person's keypoints, centre and silhouette moved
with it; a slot is valid where a person fills it and its centre lies in
the crop), then keypoint L1 over the valid slots' visible keypoints, the
silhouette chamfer over each slot (a mean over the valid slots), the
critic's score (a mean over the valid slots) and the detection loss
(binary cross-entropy of every patch's logit against the patches that hold
a valid slot's centre, a mean over the patches), summed into the
generator's loss; then the critic's WGAN-GP step on the valid slots (its
margin and the penalty's mean gradient are means over them). Each image's
terms divide by the step's totals, so the model runs image by image and
the gradients add up to the batch's: exact for a model without batch
statistics, and how the reference fits on one card.

The step's random numbers come from one generator in this order: the
augmentation (``augment.draws`` for the batch of images), then the
penalty's uniforms for the fake joints, shapes and rotations, in the dtype
of the fakes. ``quant``, where a function takes it, rounds every tensor
that a bfloat16 computation of the ViT and the head holds in its low
precision.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import augment, hmr2, losses, model
from . import train as ref_train

# HMR 2.0's reference pieces: the same layers, written once
HEAD_LN_EPS, VIT_LN_EPS = hmr2.HEAD_LN_EPS, hmr2.VIT_LN_EPS
_attention, _gelu, _layer_norm, _linear, _q = hmr2._attention, hmr2._gelu, hmr2._layer_norm, hmr2._linear, hmr2._q
rot6d_to_rotmat, rotmat_to_rot6d = hmr2.rot6d_to_rotmat, hmr2.rotmat_to_rot6d

PATCH = 14
REGRESSED = 53  # SMPL-X's joints but the two eyes (23, 24)
EYES = 23
DEPTH0 = 5.0
# SMPL-X's kinematic tree (kintree_table[0] of the released models; the root's 0)
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 15, 15, 15,
           20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
           21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53)
# the large-crop silhouette order: prime strides, largest first
_STRIDES = (8191, 4093, 2039, 1021, 509, 251, 127, 61, 31, 13, 7, 5, 3, 1)

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, tuple, str]]


class BodyX(NamedTuple):
    """SMPL-X's tensors: v_template (V, 3), shapedirs (10, 3V), exprdirs
    (10, 3V), posedirs (486, 3V), j_regressor (V, 55), lbs_weights (V, 55),
    joint_regressor (V, 19)."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    exprdirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    joint_regressor: torch.Tensor


class Slots(NamedTuple):
    images: torch.Tensor  # (B, S, S, 3) in [-1, 1]
    seg_points: torch.Tensor  # (B*K, P, 2)
    seg_mask: torch.Tensor  # (B*K, P)
    kp2d: torch.Tensor  # (B*K, 19, 3)
    centers: torch.Tensor  # (B, K, 2) in crop pixels
    valid: torch.Tensor  # (B, K)


class StageX(NamedTuple):
    cam: torch.Tensor  # (N, 3) [offset x, offset y, log-depth]
    translation: torch.Tensor  # (N, 3)
    shape: torch.Tensor  # (N, 10) betas
    verts: torch.Tensor
    joints: torch.Tensor  # (N, 14, 3)
    rotations: torch.Tensor  # (N, 54, 3, 3), the root left out
    kp2d: torch.Tensor  # (N, 14, 2) in [-1, 1]
    detection: torch.Tensor  # (B, patches)
    patches: torch.Tensor  # (B, K)


# --------------------------------------------------------------- shapes
def grid(cfg: dict) -> int:
    return cfg["img_size"] // PATCH


def vit_spec(cfg: dict, prefix: str = "encoder.") -> Spec:
    """(name, shape, kind) of every ViT tensor: kind 'patch', 'vit_dense',
    'pos', 'cls', 'ls', 'bias', 'ln_w' or 'ln_b'."""
    w, m, side = cfg["vit_width"], cfg["vit_mlp"], cfg["vit_pos_grid"]
    out: Spec = [(f"{prefix}pos_embed", (1, 1 + side * side, w), "pos"), (f"{prefix}cls_token", (1, 1, w), "cls"),
                 (f"{prefix}patch_embed.proj.weight", (w, 3, PATCH, PATCH), "patch"),
                 (f"{prefix}patch_embed.proj.bias", (w,), "bias")]

    def dense(name, fin, fout):
        out.extend([(f"{name}.weight", (fout, fin), "vit_dense"), (f"{name}.bias", (fout,), "bias")])

    def ln(name):
        out.extend([(f"{name}.weight", (w,), "ln_w"), (f"{name}.bias", (w,), "ln_b")])

    for i in range(cfg["vit_depth"]):
        b = f"{prefix}blocks.{i}."
        ln(b + "norm1")
        dense(b + "attn.qkv", w, 3 * w)
        dense(b + "attn.proj", w, w)
        ln(b + "norm2")
        dense(b + "mlp.fc1", w, m)
        dense(b + "mlp.fc2", m, w)
        out.extend([(b + "ls1.gamma", (w,), "ls"), (b + "ls2.gamma", (w,), "ls")])
    ln(prefix + "last_norm")
    return out


def head_spec(cfg: dict, prefix: str = "head.") -> Spec:
    """The HPH's tensors: kind 'dense' (out, in), 'dense_out' (the four
    read-outs), 'bias', 'ln_w' or 'ln_b'."""
    w, inner, m = cfg["head_width"], cfg["head_heads"] * cfg["head_dim_head"], cfg["head_mlp"]
    vit, ctx = cfg["vit_width"], cfg["vit_width"] + 4 * cfg["ray_bands"]
    out: Spec = []

    def dense(name, fin, fout, bias=True, kind="dense"):
        out.append((f"{name}.weight", (fout, fin), kind))
        if bias:
            out.append((f"{name}.bias", (fout,), "bias"))

    def ln(name):
        out.extend([(f"{name}.weight", (w,), "ln_w"), (f"{name}.bias", (w,), "ln_b")])

    dense(prefix + "detect", vit, 1)
    dense(prefix + "query", ctx, w)
    for i in range(cfg["head_depth"]):
        l = f"{prefix}layers.{i}."  # noqa: E741
        ln(l + "self_norm")
        dense(l + "self_qkv", w, 3 * inner, bias=False)
        dense(l + "self_out", inner, w)
        ln(l + "cross_norm")
        dense(l + "cross_q", w, inner, bias=False)
        dense(l + "cross_kv", ctx, 2 * inner, bias=False)
        dense(l + "cross_out", inner, w)
        ln(l + "ff_norm")
        dense(l + "ff1", w, m)
        dense(l + "ff2", m, w)
    dense(prefix + "decpose", w, 6 * REGRESSED, kind="dense_out")
    dense(prefix + "decshape", w, 10, kind="dense_out")
    dense(prefix + "decexpr", w, cfg["num_expression"], kind="dense_out")
    dense(prefix + "deccam", w, 3, kind="dense_out")
    return out


def critic_spec(rotation_joints: int) -> Spec:
    """The critic's dense layers (``model.critic_spec``'s), its rotation
    stream taking ``rotation_joints`` x 9 inputs."""
    return [(n, (s[0], rotation_joints * 9) if n == "rotation_dense_1.weight" else s, k)
            for n, s, k in model.critic_spec()]


# ----------------------------------------------------------- the model
def vit(images, p: Params, cfg: dict, quant: model.Quant = None, prefix: str = "encoder.") -> torch.Tensor:
    """images (N, S, S, 3) in [-1, 1] -> tokens (N, 1 + patches, width),
    the class token first. It has no stochastic depth."""
    if cfg["drop_path_rate"]:
        raise ValueError("the reference's ViT has no stochastic depth")
    e, side, g = prefix, cfg["vit_pos_grid"], grid(cfg)
    x = images.permute(0, 3, 1, 2).to(p[e + "pos_embed"].dtype)
    x = F.conv2d(_q(quant, x), _q(quant, p[e + "patch_embed.proj.weight"]), p[e + "patch_embed.proj.bias"],
                 stride=PATCH)
    x = _q(quant, x).flatten(2).transpose(1, 2)
    pos = p[e + "pos_embed"]
    patch_pos = pos[:, 1:]
    if side != g:
        stored = patch_pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        patch_pos = F.interpolate(stored, size=(g, g), mode="bicubic", align_corners=False)
        patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, g * g, -1)
    cls = (p[e + "cls_token"] + pos[:, :1]).expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x + patch_pos], dim=1)
    for i in range(cfg["vit_depth"]):
        b = f"{e}blocks.{i}."
        q, k, v = _linear(_layer_norm(x, p, b + "norm1", VIT_LN_EPS), p, b + "attn.qkv", quant).chunk(3, -1)
        x = x + _linear(_attention(q, k, v, cfg["vit_heads"], quant), p, b + "attn.proj", quant) * p[b + "ls1.gamma"]
        y = _q(quant, _gelu(_linear(_layer_norm(x, p, b + "norm2", VIT_LN_EPS), p, b + "mlp.fc1", quant)))
        x = x + _linear(y, p, b + "mlp.fc2", quant) * p[b + "ls2.gamma"]
    return _layer_norm(x, p, e + "last_norm", VIT_LN_EPS)


def intrinsics(cfg: dict) -> Tuple[float, float]:
    """(focal, principal point) in pixels."""
    s = cfg["img_size"]
    return 0.5 * s / math.tan(math.radians(cfg["fov_deg"] / 2)), 0.5 * s


def rays(cfg: dict, device) -> torch.Tensor:
    """(patches, 4 ray_bands): the Fourier embedding of each patch centre's
    ray, patches row by row; per patch the x coordinate's sines at the
    bands, its cosines, then the y coordinate's."""
    f, c = intrinsics(cfg)
    g = grid(cfg)
    out = []
    for row in range(g):
        for col in range(g):
            out.append(((col + 0.5) * PATCH, (row + 0.5) * PATCH))
    r = (torch.tensor(out, dtype=torch.float32, device=device) - c) / f  # (patches, 2) [x, y]
    bands = cfg["ray_bands"]
    freq = math.pi * torch.tensor([2.0**b for b in range(bands)], device=device)
    a = r[:, :, None] * freq  # (patches, 2, bands)
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1).reshape(g * g, 4 * bands)


def _attention_masked(q, k, v, heads: int, keep, quant: model.Quant = None):
    """``_attention`` with keep (N, Tq, Tk) bool: a score hidden where
    False."""
    n, tq, inner = q.shape
    d = inner // heads
    split = lambda t: t.reshape(n, t.shape[1], heads, d).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    s = torch.where(keep[:, None], s, torch.full_like(s, float("-inf")))
    return _q(quant, (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(n, tq, inner))


def patch_of(centers, cfg: dict) -> torch.Tensor:
    """(..., 2) pixel centres [x, y] -> the index of the patch holding
    each, row by row (clamped to the grid)."""
    g = grid(cfg)
    col = torch.clamp(torch.floor(centers[..., 0] / PATCH), 0, g - 1).long()
    row = torch.clamp(torch.floor(centers[..., 1] / PATCH), 0, g - 1).long()
    return row * g + col


def initial(mean_theta, n: int, cfg: dict):
    """The first estimate from the (1, 85) mean theta on ``n`` rows."""
    pose = torch.zeros(1, REGRESSED, 3, dtype=mean_theta.dtype, device=mean_theta.device)
    pose = torch.cat([mean_theta[:, 3:69].reshape(1, 22, 3), pose[:, 22:]], dim=1)
    pose6d = rotmat_to_rot6d(model.rodrigues(pose)).reshape(1, 6 * REGRESSED)
    cam = torch.zeros(1, 3, dtype=mean_theta.dtype, device=mean_theta.device)
    expr = torch.zeros(1, cfg["num_expression"], dtype=mean_theta.dtype, device=mean_theta.device)
    return [t.expand(n, -1) for t in (cam, pose6d, mean_theta[:, 75:85], expr)]


def hph(tokens, centers, valid, mean_theta, p: Params, cfg: dict, quant: model.Quant = None, prefix: str = "head."):
    """The head over the ViT's tokens (B, 1 + patches, width) and the slots
    (centres (B, K, 2), valid (B, K)): ((cam, 6D pose, betas, expression)
    per slot, the detection logits (B, patches), the slots' patches)."""
    h, heads = prefix, cfg["head_heads"]
    b, k = centers.shape[:2]
    patches_tok = tokens[:, 1:]
    detection = _linear(patches_tok, p, h + "detect", quant)[..., 0]
    context = torch.cat([patches_tok, rays(cfg, tokens.device).to(tokens.dtype).expand(b, -1, -1)], -1)
    patches = patch_of(centers, cfg)
    x = torch.stack([context[i, patches[i]] for i in range(b)])  # (B, K, ctx)
    x = _linear(x, p, h + "query", quant)
    keep = (valid > 0)[:, None, :] | torch.eye(k, dtype=torch.bool, device=valid.device)  # (B, K, K)
    for i in range(cfg["head_depth"]):
        l = f"{h}layers.{i}."  # noqa: E741
        q, kk, v = _linear(_layer_norm(x, p, l + "self_norm", HEAD_LN_EPS), p, l + "self_qkv", quant).chunk(3, -1)
        x = x + _linear(_attention_masked(q, kk, v, heads, keep, quant), p, l + "self_out", quant)
        kk, v = _linear(context, p, l + "cross_kv", quant).chunk(2, -1)
        q = _linear(_layer_norm(x, p, l + "cross_norm", HEAD_LN_EPS), p, l + "cross_q", quant)
        x = x + _linear(_attention(q, kk, v, heads, quant), p, l + "cross_out", quant)
        y = _q(quant, _gelu(_linear(_layer_norm(x, p, l + "ff_norm", HEAD_LN_EPS), p, l + "ff1", quant)))
        x = x + _linear(y, p, l + "ff2", quant)
    x = x.reshape(b * k, -1)
    cam, pose6d, betas, expr = initial(mean_theta, b * k, cfg)
    est = (cam + _linear(x, p, h + "deccam", quant), pose6d + _linear(x, p, h + "decpose", quant),
           betas + _linear(x, p, h + "decshape", quant), expr + _linear(x, p, h + "decexpr", quant))
    return est, detection, patches


def translation(cam, patches, cfg: dict):
    """(N, 3): ``z K^-1 [u, v, 1]`` at the offset point of each slot's
    centre patch and the depth DEPTH0 exp(cam[2])."""
    f, c = intrinsics(cfg)
    g = grid(cfg)
    col, row = (patches % g).to(cam.dtype), (patches // g).to(cam.dtype)
    u = (col + 0.5 + cam[:, 0]) * PATCH
    v = (row + 0.5 + cam[:, 1]) * PATCH
    z = DEPTH0 * torch.exp(cam[:, 2])
    return torch.stack([z * (u - c) / f, z * (v - c) / f, z], -1)


def project(points, t, cfg: dict):
    """(N, P, 3) points and (N, 3) translations -> (N, P, 2) in [-1, 1]."""
    f, c = intrinsics(cfg)
    q = points + t[:, None, :]
    return (f * q[..., :2] / q[..., 2:] + c) * (2.0 / cfg["img_size"]) - 1.0


def smplx(body: BodyX, beta, pose=None, rot=None, expression=None, joints: str = "lsp"):
    """SMPL-X from the betas (N, 10), the pose as axis-angle (N, 165) or
    matrices ``rot`` (N, 55, 3, 3), and the expression (N, 10) or a neutral
    one: (verts, keypoints, rotations)."""
    n, v = beta.shape[0], body.v_template.shape[0]
    blend = beta @ body.shapedirs
    if expression is not None:
        blend = blend + expression @ body.exprdirs
    v_shaped = blend.reshape(n, v, 3) + body.v_template
    rest = torch.einsum("nvc,vk->nkc", v_shaped, body.j_regressor)
    if rot is None:
        rot = model.rodrigues(pose.reshape(n, len(PARENTS), 3))
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = ((rot[:, 1:] - eye).reshape(n, 9 * (len(PARENTS) - 1)) @ body.posedirs).reshape(n, v, 3) + v_shaped
    world_r, world_t = [rot[:, 0]], [rest[:, 0]]
    for j in range(1, len(PARENTS)):
        q = PARENTS[j]
        world_t.append(world_t[q] + (world_r[q] @ (rest[:, j] - rest[:, q])[..., None])[..., 0])
        world_r.append(world_r[q] @ rot[:, j])
    world_r, world_t = torch.stack(world_r, 1), torch.stack(world_t, 1)
    skin_t = world_t - (world_r @ rest[..., None])[..., 0]
    blended = body.lbs_weights @ torch.cat([world_r.reshape(n, len(PARENTS), 9), skin_t], -1)
    verts = (blended[..., :9].reshape(n, v, 3, 3) * v_posed[:, :, None, :]).sum(-1) + blended[..., 9:]
    reg = body.joint_regressor[:, :14] if joints == "lsp" else body.joint_regressor
    return verts, torch.einsum("nvc,vj->njc", verts, reg), rot


def multihmr(images, centers, valid, mean_theta, p: Params, body: BodyX, cfg: dict,
             quant: model.Quant = None) -> StageX:
    """The forward on B images and their K slots: one stage, rows the B x K
    slots image by image."""
    est, detection, patches = hph(vit(images, p, cfg, quant), centers, valid, mean_theta, p, cfg, quant)
    cam, pose6d, betas, expr = est
    n = cam.shape[0]
    rot = rot6d_to_rotmat(pose6d.reshape(n * REGRESSED, 6)).reshape(n, REGRESSED, 3, 3)
    eyes = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(n, 2, 3, 3)
    rot = torch.cat([rot[:, :EYES], eyes, rot[:, EYES:]], 1)
    verts, joints, rot = smplx(body, betas, rot=rot, expression=expr)
    t = translation(cam, patches.reshape(n), cfg)
    return StageX(cam, t, betas, verts, joints, rot[:, 1:], project(joints, t, cfg), detection, patches)


# ------------------------------------------------------- the input path
def silhouettes(segs, max_points: int):
    """(points (N, P, 2), prefix mask (N, P)) of (N, H, W) seg crops: the
    pixels with seg > 0, truncated to ``max_points``, in ``augment.
    silhouette``'s order for a crop of at most 2^16 pixels, and for a
    larger one in the order of the key f * stride mod H W (the largest
    prime stride of ``_STRIDES`` that does not divide H W and keeps (H W -
    1) * stride under 2^31: the keys of the pixels differ)."""
    n, h, w = segs.shape
    total = h * w
    if total <= 1 << 16:
        return augment.silhouette(segs[..., None], max_points)
    stride = next(s for s in _STRIDES if total % s and (total - 1) * s < 2**31)
    on = segs.reshape(n, total) > 0
    f = torch.arange(total, device=segs.device, dtype=torch.int64).expand(n, total)
    key = torch.where(on, (f * stride) % total, torch.full_like(f, 2**31 - 1))
    order = torch.argsort(key, dim=1)[:, :max_points]
    valid = f[:, :max_points] < on.sum(dim=1)[:, None]
    order = torch.where(valid, order, 0)
    return torch.stack([order % w, order // w], -1).float(), valid.float()


def prepare(host: dict, cfg: dict, generator=None, augment_: bool = True) -> Slots:
    """A batch of whole images with K person slots through the input path:
    the crop of ``img_size`` around the image's centre at the draws of
    ``augment.draws``, each slot's silhouette (bit k of ``seg``), keypoints
    and centre moved with it."""
    img = host["image"]
    b, ch, cw, _ = img.shape
    dev = img.device
    k = host["label"].shape[1]
    out = cfg["img_size"]
    if augment_:
        trans, scales, flips = augment.draws(b, cfg, generator, dev)
    else:
        trans = torch.zeros((b, 2), dtype=torch.int32, device=dev)
        scales, flips = torch.ones(b, device=dev), torch.zeros(b, dtype=torch.bool, device=dev)
    bits = torch.stack([((host["seg"].to(torch.int32) >> j) & 1) for j in range(k)], -1).float()
    h = torch.full((b,), ch, dtype=torch.int32, device=dev)
    w = torch.full((b,), cw, dtype=torch.int32, device=dev)
    cxj = torch.full((b,), cw // 2, dtype=torch.int32, device=dev) + trans[:, 0]
    cyj = torch.full((b,), ch // 2, dtype=torch.int32, device=dev) + trans[:, 1]
    fx = torch.floor(w.float() * scales) / w.float()
    fy = torch.floor(h.float() * scales) / h.float()
    sx = (cxj.float() * fx).to(torch.int32) - out // 2
    sy = (cyj.float() * fy).to(torch.int32) - out // 2
    wy = augment._axis(h, ch, out, scales, sy, torch.zeros_like(flips))
    wx = augment._axis(w, cw, out, scales, sx, flips)
    crops = augment._resample(img.float() / 255.0, wy, wx) * 2.0 - 1.0
    segs = augment._resample(bits, wy, wx)  # (B, S, S, K)

    kp = host["label"].to(device=dev, dtype=torch.float32)  # (B, K, 3, 19)
    x = kp[:, :, 0] * fx[:, None, None] - sx[:, None, None].float()
    y = kp[:, :, 1] * fy[:, None, None] - sy[:, None, None].float()
    vis = kp[:, :, 2]
    swap = torch.tensor(augment.FLIP_SWAP_19, device=dev)
    f = flips[:, None, None]
    x = torch.where(f, (float(out) - x - 1.0)[..., swap], x)
    y = torch.where(f, y[..., swap], y)
    vis = (torch.where(f, vis[..., swap], vis) > 0).float()
    c = host["center"].to(device=dev, dtype=torch.float32)
    cx = c[..., 0] * fx[:, None] - sx[:, None].float()
    cx = torch.where(flips[:, None], float(out) - cx - 1.0, cx)
    cy = c[..., 1] * fy[:, None] - sy[:, None].float()
    valid = ((host["present"].to(dev) > 0) & (cx >= 0) & (cx < out) & (cy >= 0) & (cy < out)).float()
    vis = vis * valid[..., None]
    lab = torch.stack([(2.0 * (x / out) - 1.0) * vis, (2.0 * (y / out) - 1.0) * vis, vis], dim=-1)
    pts, mask = silhouettes(segs.permute(0, 3, 1, 2).reshape(b * k, out, out), cfg["max_silhouette_points"])
    mask = mask * valid.reshape(-1, 1)
    return Slots(crops, pts, mask, lab.reshape(b * k, 19, 3), torch.stack([cx, cy], -1), valid)


# ------------------------------------------------------------ the step
def _masked_mean(x, rows):
    keep = (rows > 0).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(keep, x, torch.zeros_like(x)).sum(0) / rows.sum().clamp_min(1.0)


def train_step(state: ref_train.State, body: BodyX, cfg: dict, host: dict, mocap_raw, generator,
               quant: model.Quant = None, det_per_image: bool = False) -> Dict[str, torch.Tensor]:
    """One hybrid step on ``state`` in place, image by image (the module
    docstring). Returns the step's losses and both gradients.
    ``det_per_image``: a planted fault for ``drivers/train_mhmr.control``,
    each image's detection loss a mean over its own patches, summed over
    the images."""
    dtype = state.gen["mean_theta"].dtype
    dev = host["image"].device
    c = model.bone_matrix(dev, dtype)
    batch = prepare(host, cfg, generator)
    batch = Slots(*(t.to(dtype) for t in batch))
    b, k = batch.valid.shape
    with torch.no_grad():
        pose, shape = (t.to(dtype) for t in mocap_raw)
        _, real_j, real_rot = smplx(body, shape, pose=pose, joints="cocoplus")
        real_j, real_rot = real_j[:, :14], real_rot[:, 1:]

    # the step's totals, by which every image's terms divide
    rows = batch.valid.reshape(-1)
    n_valid = rows.sum().clamp_min(1.0)
    n_vis = (torch.count_nonzero(batch.kp2d[:, :14, 2:3]) * 2).clamp_min(1).to(dtype)
    n_patches = float((1 if det_per_image else b) * grid(cfg) ** 2)
    v = body.v_template.shape[0]

    gen = {name: t.detach().requires_grad_() for name, t in state.gen.items()}
    names = list(gen)
    gen_grads = {name: torch.zeros_like(t) for name, t in gen.items()}
    totals = {"kpr": 0.0, "mr": 0.0, "gc": 0.0, "det": 0.0}
    fakes = []
    for i in range(b):
        s = slice(i * k, (i + 1) * k)
        st = multihmr(batch.images[i : i + 1], batch.centers[i : i + 1], batch.valid[i : i + 1], gen["mean_theta"],
                      gen, body, cfg, quant)
        kp = batch.kp2d[s, :14]
        vis = kp[..., 2:3]
        kpr = torch.where(vis > 0, (kp[..., :2] - st.kp2d).abs() * vis, torch.zeros_like(st.kp2d)).sum() / n_vis
        px = (project(st.verts, st.translation, cfg) + 1.0) * 0.5 * float(cfg["img_size"])
        mr = (losses.chamfer(batch.seg_points[s], batch.seg_mask[s], px) / (3.0 + v)).sum() / n_valid
        scores = model.critic(state.critic, model.kcs(st.joints, c), st.joints[:, :14], st.shape, st.rotations)
        gc = -torch.where(rows[s, None] > 0, scores, torch.zeros_like(scores)).sum(0).sum() / n_valid
        target = torch.zeros_like(st.detection).scatter_reduce(1, st.patches, batch.valid[i : i + 1], "amax")
        det = F.binary_cross_entropy_with_logits(st.detection, target, reduction="sum") / n_patches
        terms = (cfg["kpr_loss_weight"] * kpr, cfg["mr_loss_weight"] * mr, cfg["critic_loss_weight"] * gc, det)
        loss = sum(terms)
        grads = torch.autograd.grad(loss, [gen[n] for n in names], allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                gen_grads[n] += g
        for key, t in zip(totals, terms):
            totals[key] = totals[key] + t.detach()
        fakes.append((st.joints[:, :14].detach(), st.shape.detach(), st.rotations.detach()))
        del st, loss, grads
    gen_loss = totals["kpr"] + totals["mr"] + totals["gc"] + totals["det"]
    state.gen_adam.step(state.gen, gen_grads)

    # ---- critic, on the valid slots
    fake_j, fake_s, fake_r = (torch.cat(t) for t in zip(*fakes))
    cp = {name: t.detach().requires_grad_() for name, t in state.critic.items()}
    real_out = model.critic(cp, model.kcs(real_j, c), real_j, shape, real_rot)
    fake_out = model.critic(cp, model.kcs(fake_j, c), fake_j, fake_s, fake_r)
    wgan = _masked_mean(fake_out - real_out, rows).sum()
    alpha, beta, gamma = (torch.rand(t.shape, generator=generator, device=dev, dtype=t.dtype)
                          for t in (fake_j, fake_s, fake_r))
    i_j = (fake_j + alpha * (real_j - fake_j)).detach()
    i_s = (fake_s + beta * (shape - fake_s)).detach()
    i_r = (fake_r + gamma * (real_rot - fake_r)).detach()
    i_k = model.kcs(i_j, c)
    inputs = [t.requires_grad_() for t in (i_k, i_j, i_s, i_r)]
    out = model.critic(cp, i_k, i_j[:, :14], i_s, i_r)
    penalty = i_j.new_zeros(())
    for g in torch.autograd.grad(out.sum(), inputs, create_graph=True):
        penalty = penalty + (1.0 - torch.linalg.vector_norm(_masked_mean(g, rows).reshape(-1))) ** 2
    c_loss = wgan + 10.0 * penalty
    cnames = list(cp)
    cg = torch.autograd.grad(c_loss, [cp[n] for n in cnames], allow_unused=True)
    critic_grads = {n: (torch.zeros_like(cp[n]) if g is None else g) for n, g in zip(cnames, cg)}
    state.critic_adam.step(state.critic, critic_grads)
    stack = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).reshape(1)  # noqa: E731
    return {
        "kpr_losses": stack(totals["kpr"]), "mr_losses": stack(totals["mr"]), "gen_critic_losses": stack(totals["gc"]),
        "generator_loss": gen_loss.detach(), "critic_loss": c_loss.detach(), "critic_penalty": penalty.detach(),
        "detection_loss": totals["det"].detach(), "gen_grads": gen_grads, "critic_grads": critic_grads,
    }


def new_state(hmr_sd: Params, mean: torch.Tensor, critic_sd: Params, cfg: dict) -> ref_train.State:
    """The reference's training state from the benchmark's tensors (copies)."""
    gen = {name: t.clone() for name, t in hmr_sd.items()}
    gen["mean_theta"] = mean.clone()
    return ref_train.State(gen, {}, {name: t.clone() for name, t in critic_sd.items()},
                           ref_train.Adam(cfg["generator_lr"]), ref_train.Adam(cfg["critic_lr"]))

