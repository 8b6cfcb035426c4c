"""The plain reference of HMR 2.0's model (Goel et al., "Humans in 4D", ICCV
2023, arXiv:2305.20086; ``hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml``
in github.com/shubham-goel/4D-Humans) and of the hybrid training step on it.

Written from the published description in functional form over a dict of
tensors named as the state dict that the benchmark loads into the system
under test; it imports nothing of the system under test. Every function
computes in the dtype of its parameters; the benchmark runs it in float32
with TF32 off.

* **The ViT** (ViTPose-H): the middle 3/4 of the columns of each square
  crop (256 x 192 of 256 x 256); the patch embedding Conv2d(3 -> width,
  kernel 16, stride 16, padding 2); the learned position (1, 1 + tokens,
  width) added as ``pos[:, 1:] + pos[:, :1]``; ``depth`` pre-LN blocks
  ``x += dp(attn(LN(x)))``, ``x += dp(mlp(LN(x)))`` with biased qkv and out
  projections, softmax(q k^T / sqrt(d)) v per head, the MLP width -> mlp,
  exact GELU, -> width, LayerNorm eps 1e-6; a final LayerNorm.
  Stochastic depth at ``linspace(0, drop_path_rate, depth)`` (f32 values)
  per block: a row is kept where floor(keep + u) is 1 and scaled by 1 /
  keep.
* **The head** (``SMPLTransformerDecoderHead``): a zero token of width 1
  embedded by Linear(1, width) plus a learned position; ``depth`` layers of
  pre-LN self-attention (qkv without bias), cross-attention to the ViT's
  tokens (q and kv without bias; the tokens are not normalised) and a
  feed-forward width -> mlp, GELU, -> width, each with a residual, LayerNorm
  eps 1e-5; read out by ``decpose`` (24 x 6D), ``decshape`` and ``deccam``,
  each added to the estimate it refines.
* **6D to matrices**: HMR 2.0's ``rot6d_to_rotmat`` (reshape (2, 3),
  transpose, Gram-Schmidt, the cross product).
* **SMPL from matrices**: the body model of ``model.smpl`` with the
  rotations given, Rodrigues skipped.

Departures from the publication, each also the system's:

* the mean is the benchmark's 85-d mean theta [cam | axis-angle pose |
  shape], a trained leaf, turned into the 6D form (the first two columns
  of each rotation) on every forward; HMR 2.0 keeps a fixed 6D mean;
* the camera is the repository's weak perspective, not HMR 2.0's
  perspective camera of focal length 5000; the crops are [-1, 1], not
  ImageNet-normalised;
* the step is the repository's hybrid step (``train.train_step``): the
  keypoint L1, the silhouette chamfer and the KCS critic with WGAN-GP in
  place of HMR 2.0's 3D-keypoint, SMPL-parameter and discriminator losses;
  Adam (eps 1e-7) without weight decay in place of AdamW;
* ``num_stage`` head iterations (HMR 2.0's ``IEF_ITERS``, 1 in its config).

The step's random numbers come from one generator in this order: the
augmentation (``augment.draws``), the ViT's stochastic-depth masks (block
by block, the attention branch's then the MLP branch's, (N,) f32 uniforms
each, none at rate 0), then the penalty's uniforms for the fake joints,
shapes and rotations, in the dtype of the fakes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import augment, losses, model
from . import train as ref_train

PATCH, PATCH_PAD = 16, 2
VIT_LN_EPS, HEAD_LN_EPS = 1e-6, 1e-5
NUM_JOINTS = 24

Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, tuple, str]]


# --------------------------------------------------------------- shapes
def crop(img_size: int) -> Tuple[int, int]:
    """(first column, width) of the crop's part that the ViT sees."""
    width = img_size * 3 // 4
    return (img_size - width) // 2, width


def num_tokens(img_size: int) -> int:
    return (img_size // PATCH) * (crop(img_size)[1] // PATCH)


def vit_spec(cfg: dict, prefix: str = "encoder.") -> Spec:
    """(name, shape, kind) of every ViT tensor: kind 'patch' (the OIHW
    convolution), 'vit_dense' (out, in), 'pos', 'bias', 'ln_w' or 'ln_b'."""
    w, m = cfg["vit_width"], cfg["vit_mlp"]
    out: Spec = [(f"{prefix}pos_embed", (1, 1 + num_tokens(cfg["img_size"]), w), "pos"),
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
    ln(prefix + "last_norm")
    return out


def head_spec(cfg: dict, prefix: str = "head.") -> Spec:
    """The head's tensors: kind 'dense' (out, in), 'dense_out' (the three
    read-outs), 'token' (the token embedding's (width, 1)), 'head_pos',
    'bias', 'ln_w' or 'ln_b'."""
    w, inner, m, ctx = cfg["head_width"], cfg["head_heads"] * cfg["head_dim_head"], cfg["head_mlp"], cfg["vit_width"]
    out: Spec = [(f"{prefix}token_embedding.weight", (w, 1), "token"), (f"{prefix}token_embedding.bias", (w,), "bias"),
                 (f"{prefix}pos_embedding", (1, 1, w), "head_pos")]

    def dense(name, fin, fout, bias=True, kind="dense"):
        out.append((f"{name}.weight", (fout, fin), kind))
        if bias:
            out.append((f"{name}.bias", (fout,), "bias"))

    def ln(name):
        out.extend([(f"{name}.weight", (w,), "ln_w"), (f"{name}.bias", (w,), "ln_b")])

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
    dense(prefix + "decpose", w, 6 * NUM_JOINTS, kind="dense_out")
    dense(prefix + "decshape", w, 10, kind="dense_out")
    dense(prefix + "deccam", w, 3, kind="dense_out")
    return out


def drop_rates(cfg: dict) -> List[float]:
    """Each block's stochastic-depth rate: ViTPose's f32 linspace."""
    return torch.linspace(0, cfg["drop_path_rate"], cfg["vit_depth"], device="cpu").tolist()


# ------------------------------------------------------------- pieces
def _q(quant: model.Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(x, p: Params, name: str, quant: model.Quant = None):
    """``x @ W^T + b`` (no bias where the layer has none), with ``quant`` on
    both operands and the result, where a bfloat16 computation rounds."""
    y = _q(quant, x) @ _q(quant, p[name + ".weight"]).T
    if name + ".bias" in p:
        y = y + p[name + ".bias"]
    return _q(quant, y)


def _layer_norm(x, p: Params, name: str, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[name + ".weight"] + p[name + ".bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _attention(q, k, v, heads: int, quant: model.Quant = None):
    """(N, Tq, H*D), (N, Tk, H*D) x2 -> (N, Tq, H*D): per head
    softmax(q k^T / sqrt(D)) v."""
    n, tq, inner = q.shape
    d = inner // heads
    split = lambda t: t.reshape(n, t.shape[1], heads, d).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    a = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return _q(quant, (a @ v).transpose(1, 2).reshape(n, tq, inner))


def drop_path(x, rate: float, generator, quant: model.Quant = None):
    """timm's ``drop_path``: one (N,) f32 uniform draw; rows kept where
    floor(keep + u) == 1, scaled by 1 / keep."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],), generator=generator, device=x.device)
    return _q(quant, x / keep) * torch.floor(keep + u).to(x.dtype)[:, None, None]


# ----------------------------------------------------------- the model
def vit(images, p: Params, cfg: dict, train: bool, generator=None, quant: model.Quant = None,
        prefix: str = "encoder.") -> torch.Tensor:
    """images (N, S, S, 3) in [-1, 1] -> tokens (N, tokens, width)."""
    e = prefix
    c0, width = crop(images.shape[1])
    x = images[:, :, c0 : c0 + width].permute(0, 3, 1, 2).to(p[e + "pos_embed"].dtype)
    x = F.conv2d(_q(quant, x), _q(quant, p[e + "patch_embed.proj.weight"]), p[e + "patch_embed.proj.bias"],
                 stride=PATCH, padding=PATCH_PAD)
    x = _q(quant, x).flatten(2).transpose(1, 2)
    pos = p[e + "pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    for i, rate in enumerate(drop_rates(cfg)):
        b = f"{e}blocks.{i}."
        rate = rate if train else 0.0
        q, k, v = _linear(_layer_norm(x, p, b + "norm1", VIT_LN_EPS), p, b + "attn.qkv", quant).chunk(3, -1)
        x = x + drop_path(_linear(_attention(q, k, v, cfg["vit_heads"], quant), p, b + "attn.proj", quant),
                          rate, generator, quant)
        y = _q(quant, _gelu(_linear(_layer_norm(x, p, b + "norm2", VIT_LN_EPS), p, b + "mlp.fc1", quant)))
        x = x + drop_path(_linear(y, p, b + "mlp.fc2", quant), rate, generator, quant)
    return _layer_norm(x, p, e + "last_norm", VIT_LN_EPS)


def head(context, p: Params, estimate, cfg: dict, quant: model.Quant = None, prefix: str = "head."):
    """One head iteration: (cam, 6D pose, shape) refined from the tokens."""
    h, heads = prefix, cfg["head_heads"]
    cam, pose6d, shape = estimate
    x = _linear(context.new_zeros(context.shape[0], 1, 1), p, h + "token_embedding", quant) + p[h + "pos_embedding"]
    for i in range(cfg["head_depth"]):
        l = f"{h}layers.{i}."  # noqa: E741
        q, k, v = _linear(_layer_norm(x, p, l + "self_norm", HEAD_LN_EPS), p, l + "self_qkv", quant).chunk(3, -1)
        x = x + _linear(_attention(q, k, v, heads, quant), p, l + "self_out", quant)
        k, v = _linear(context, p, l + "cross_kv", quant).chunk(2, -1)
        q = _linear(_layer_norm(x, p, l + "cross_norm", HEAD_LN_EPS), p, l + "cross_q", quant)
        x = x + _linear(_attention(q, k, v, heads, quant), p, l + "cross_out", quant)
        y = _q(quant, _gelu(_linear(_layer_norm(x, p, l + "ff_norm", HEAD_LN_EPS), p, l + "ff1", quant)))
        x = x + _linear(y, p, l + "ff2", quant)
    x = x[:, 0]
    return (cam + _linear(x, p, h + "deccam", quant), pose6d + _linear(x, p, h + "decpose", quant),
            shape + _linear(x, p, h + "decshape", quant))


def rot6d_to_rotmat(x):
    """HMR 2.0's ``rot6d_to_rotmat``: (B, 6) -> (B, 3, 3)."""
    x = x.reshape(-1, 2, 3).permute(0, 2, 1).contiguous()
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1)
    b2 = F.normalize(a2 - torch.einsum("bi,bi->b", b1, a2).unsqueeze(-1) * b1)
    b3 = torch.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def rotmat_to_rot6d(r):
    """(..., 3, 3) -> (..., 6): the first column, then the second."""
    return torch.cat([r[..., :, 0], r[..., :, 1]], dim=-1)


def smpl_from_rotations(body: model.Body, beta, rot, joints: str = "lsp"):
    """``model.smpl`` with the rotations (N, 24, 3, 3) given: (verts,
    keypoints, rotations)."""
    n, v = beta.shape[0], body.v_template.shape[0]
    v_shaped = (beta @ body.shapedirs).reshape(n, v, 3) + body.v_template
    rest = torch.einsum("nvc,vk->nkc", v_shaped, body.j_regressor)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = ((rot[:, 1:] - eye).reshape(n, model.POSE_FEATURE_DIM) @ body.posedirs).reshape(n, v, 3) + v_shaped
    world_r, world_t = [rot[:, 0]], [rest[:, 0]]
    for k in range(1, NUM_JOINTS):
        q = model.SMPL_PARENTS[k]
        world_t.append(world_t[q] + (world_r[q] @ (rest[:, k] - rest[:, q])[..., None])[..., 0])
        world_r.append(world_r[q] @ rot[:, k])
    world_r, world_t = torch.stack(world_r, 1), torch.stack(world_t, 1)
    skin_t = world_t - (world_r @ rest[..., None])[..., 0]
    blended = body.lbs_weights @ torch.cat([world_r.reshape(n, NUM_JOINTS, 9), skin_t], -1)
    verts = (blended[..., :9].reshape(n, v, 3, 3) * v_posed[:, :, None, :]).sum(-1) + blended[..., 9:]
    reg = body.joint_regressor[:, :14] if joints == "lsp" else body.joint_regressor
    return verts, torch.einsum("nvc,vj->njc", verts, reg), rot


def hmr2(images, mean_theta, p: Params, body: model.Body, cfg: dict, train: bool = False, generator=None,
         quant: model.Quant = None) -> List[model.Stage]:
    """The forward: the ViT, ``num_stage`` head iterations from the mean,
    the body model from each iteration's matrices. A stage's ``theta`` is
    [cam | 6D pose | shape]."""
    context = vit(images, p, cfg, train, generator, quant)
    n = images.shape[0]
    pose = rotmat_to_rot6d(model.rodrigues(mean_theta[:, 3:75].reshape(-1, NUM_JOINTS, 3))).reshape(-1, 6 * NUM_JOINTS)
    estimate = (mean_theta[:, :3].expand(n, -1), pose.expand(n, -1), mean_theta[:, 75:].expand(n, -1))
    out = []
    for _ in range(cfg["num_stage"]):
        estimate = head(context, p, estimate, cfg, quant)
        cam, pose6d, shape = estimate
        verts, joints, rot = smpl_from_rotations(body, shape, rot6d_to_rotmat(pose6d).reshape(n, NUM_JOINTS, 3, 3))
        out.append(model.Stage(torch.cat([cam, pose6d, shape], -1), cam, shape, verts, joints, rot[:, 1:],
                               model.project(joints, cam)))
    return out


# ------------------------------------------------------------ the step
def train_step(state: ref_train.State, body: model.Body, cfg: dict, host: dict, mocap_raw, generator,
               quant: model.Quant = None) -> Dict[str, torch.Tensor]:
    """``train.train_step`` on HMR 2.0's model: one hybrid step on
    ``state`` in place (no BatchNorm, so ``state.bufs`` stays empty).
    Returns the step's losses and both gradients (name -> tensor). The
    prepared batch and the mocap are taken to the parameters' dtype."""
    dtype = state.gen["mean_theta"].dtype
    dev = host["image"].device
    c = model.bone_matrix(dev, dtype)
    batch = augment.prepare(host, cfg, generator, augment=True)
    batch = augment.Prepared(*(t.to(dtype) for t in batch))
    with torch.no_grad():
        pose, shape = (t.to(dtype) for t in mocap_raw)
        _, real_j, real_rot = model.smpl(body, shape, pose, "cocoplus")
        real_j, real_rot = real_j[:, :14], real_rot[:, 1:]

    # ---- generator
    gen = {k: v.detach().requires_grad_() for k, v in state.gen.items()}
    stages = hmr2(batch.images, gen["mean_theta"], gen, body, cfg, train=True, generator=generator, quant=quant)
    kpr, mr, gc = ref_train.stage_losses(stages, batch, state.critic, c, cfg)
    hinge = cfg["cam_scale_hinge"] * torch.relu(cfg["cam_scale_margin"] - stages[-1].cam[:, 0]).square().mean()
    loss = kpr[-1] + mr[-1] + gc[-1] + hinge
    names = list(gen)
    g = torch.autograd.grad(loss, [gen[k] for k in names], allow_unused=True)
    gen_grads = {k: (torch.zeros_like(gen[k]) if gi is None else gi) for k, gi in zip(names, g)}
    state.gen_adam.step(state.gen, gen_grads)

    # ---- critic
    fake_j = torch.cat([s.joints[:, :14] for s in stages]).detach()
    fake_s = torch.cat([s.shape for s in stages]).detach()
    fake_r = torch.cat([s.rotations for s in stages]).detach()
    cp = {k: v.detach().requires_grad_() for k, v in state.critic.items()}
    real_out = model.critic(cp, model.kcs(real_j, c), real_j, shape, real_rot)
    fake_out = model.critic(cp, model.kcs(fake_j, c), fake_j, fake_s, fake_r)
    wgan = (fake_out - real_out).mean(0).sum()
    alpha, beta, gamma = (torch.rand(t.shape, generator=generator, device=dev, dtype=t.dtype)
                          for t in (fake_j, fake_s, fake_r))
    i_j = (fake_j + alpha * (real_j - fake_j)).detach()
    i_s = (fake_s + beta * (shape - fake_s)).detach()
    i_r = (fake_r + gamma * (real_rot - fake_r)).detach()
    i_k = model.kcs(i_j, c)
    inputs = [t.requires_grad_() for t in (i_k, i_j, i_s, i_r)]
    out = model.critic(cp, i_k, i_j[:, :14], i_s, i_r)
    penalty = losses.gradient_penalty(torch.autograd.grad(out.sum(), inputs, create_graph=True))
    c_loss = wgan + 10.0 * penalty
    cnames = list(cp)
    cg = torch.autograd.grad(c_loss, [cp[k] for k in cnames], allow_unused=True)
    critic_grads = {k: (torch.zeros_like(cp[k]) if gi is None else gi) for k, gi in zip(cnames, cg)}
    state.critic_adam.step(state.critic, critic_grads)
    return {
        "kpr_losses": kpr.detach(), "mr_losses": mr.detach(), "gen_critic_losses": gc.detach(),
        "generator_loss": loss.detach(), "critic_loss": c_loss.detach(), "critic_penalty": penalty.detach(),
        "gen_grads": gen_grads, "critic_grads": critic_grads,
    }


def new_state(hmr_sd: Params, mean: torch.Tensor, critic_sd: Params, cfg: dict) -> ref_train.State:
    """The reference's training state from the benchmark's tensors (copies)."""
    gen = {k: v.clone() for k, v in hmr_sd.items()}
    gen["mean_theta"] = mean.clone()
    return ref_train.State(gen, {}, {k: v.clone() for k, v in critic_sd.items()},
                           ref_train.Adam(cfg["generator_lr"]), ref_train.Adam(cfg["critic_lr"]))
