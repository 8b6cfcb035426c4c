"""Multi-HMR's weights and its SMPL-X body made from the seed, on the device,
in float32 (the type the parameters are kept in; the model computes in
bfloat16 under autocast), as ``weights_hmr2.py`` makes HMR 2.0's: every
random tensor comes from one draw of a generator on the device, cut into
leaves and scaled.

* the ViT (DINOv2's initialiser): dense layers and the position
  embedding normal, std ``vit_std`` (0.02), the class token std 1e-6, the
  patch convolution LeCun normal, std sqrt(1 / fan_in), LayerScale at
  ``layer_scale`` (a trained DINOv2's scales are of that order; its
  initial 1e-5 would leave every block's branch near nought), zero
  biases, LayerNorm scale 1 and offset 0;
* the head: dense layers Glorot normal, std sqrt(2 / (fan_in +
  fan_out)), the four read-outs std ``head_out_std`` (a small first step
  from the mean), zero biases, LayerNorm 1 and 0;
* the critic: ``weights.py``'s, its rotation stream over SMPL-X's 54
  non-root joints;
* SMPL-X: ``weights.make_body``'s construction at 55 joints, with
  expression directions of std 0.02 beside the shape's (the real model is
  licensed and not in the repository).

The mean theta is ``weights.py``'s.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .reference import multihmr as ref
from .weights import Params, _fill, _generator, mean_theta

_RANDOM = ("patch", "vit_dense", "pos", "cls", "dense", "dense_out")


def make_mhmr(cfg: dict, seed: int, device) -> Tuple[Params, torch.Tensor]:
    """(the HMR state dict: the ViT's and the head's weights, the mean theta
    (1, 85))."""
    spec = ref.vit_spec(cfg) + ref.head_spec(cfg)
    random = [(n, s, k) for n, s, k in spec if k in _RANDOM]
    draw = torch.randn(sum(math.prod(s) for _, s, _ in random), generator=_generator(seed, device), device=device)
    std = {"vit_dense": cfg["vit_std"], "pos": cfg["vit_std"], "cls": 1e-6, "dense_out": cfg["head_out_std"]}
    out: Params = {}
    at = 0
    for name, shape, kind in random:
        n = math.prod(shape)
        if kind == "patch":
            s = math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "dense":
            s = math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            s = std[kind]
        out[name] = draw[at : at + n].view(shape) * s
        at += n
    for name, shape, kind in spec:
        if kind in ("bias", "ln_b"):
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ln_w":
            out[name] = torch.ones(shape, device=device)
        elif kind == "ls":
            out[name] = torch.full(shape, cfg["layer_scale"], device=device)
    return {name: out[name] for name, _, _ in spec}, mean_theta(device)


def make_critic(cfg: dict, seed: int, device) -> Params:
    return _fill(ref.critic_spec(len(ref.PARENTS) - 1), cfg, _generator(seed + 1, device), device)


def make_body(cfg: dict, seed: int, device) -> ref.BodyX:
    """SMPL-X's tensors at the configuration's sizes."""
    g = _generator(seed + 2, device)
    v, k, kp = cfg["num_verts"], len(ref.PARENTS), 19
    template = torch.rand(v, 3, generator=g, device=device) * 2.0 - 1.0
    shapedirs = 0.03 * torch.randn(cfg["num_betas"], 3 * v, generator=g, device=device)
    exprdirs = 0.02 * torch.randn(cfg["num_expression"], 3 * v, generator=g, device=device)
    posedirs = 0.01 * torch.randn(9 * (k - 1), 3 * v, generator=g, device=device)
    # each regressed point: a convex combination of 8 random vertices
    order = torch.rand(k + kp, v, generator=g, device=device).argsort(dim=1)[:, :8]
    w = torch.rand(k + kp, 8, generator=g, device=device) * 0.9 + 0.1
    reg = torch.zeros(k + kp, v, device=device).scatter_(1, order, w / w.sum(1, keepdim=True)).T.contiguous()
    j_reg, kp_reg = reg[:, :k].contiguous(), reg[:, k:].contiguous()
    rest = template.T @ j_reg  # (3, 55)
    d2 = ((template[:, :, None] - rest[None]) ** 2).sum(1)
    lbs = torch.exp(-d2 / (0.5 + d2.mean()))
    lbs = lbs / lbs.sum(1, keepdim=True)
    return ref.BodyX(template, shapedirs, exprdirs, posedirs, j_reg, lbs, kp_reg)


def program_body(body: ref.BodyX, device):
    """The SMPL-X tensors as the program's body model."""
    from human_pose_estimation_tpu_torch.core.smpl import SMPLX_PARENTS, SMPLModel

    return SMPLModel(body.v_template.clone(), body.shapedirs.clone(), body.posedirs.clone(), body.j_regressor.clone(),
                     body.lbs_weights.clone(), body.joint_regressor.clone(), parents=SMPLX_PARENTS,
                     exprdirs=body.exprdirs.clone()).to(device)
