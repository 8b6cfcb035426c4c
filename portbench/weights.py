"""Weights and the body model made from the seed, on the device, in float32
(the type the parameters are kept in; the encoder computes in bfloat16
under autocast). Every random tensor of a kind comes from one draw of a
generator on the device, cut into leaves and scaled:

* convolutions: LeCun normal, std sqrt(1 / fan_in) (the initialiser of
  the reference implementation's encoder), zero biases;
* dense layers: Glorot normal, std sqrt(2 / (fan_in + fan_out)), zero
  biases; the IEF output layer: std ``ief_out_std`` of the configuration
  (a small step per stage, as the reference initialises it);
* BatchNorm: scale 1, offset 0, running mean 0 and variance 1 (statistics
  of one batch make the evaluation forward ill-conditioned: channels that
  the batch leaves nearly constant divide by a variance near 0);
* the body model: a template in [-1, 1]^3, shape and pose blend shapes of
  std 0.03 and 0.01, joint and keypoint regressors that average 8 random
  vertices each, skinning weights that fall off with the distance to each
  rest joint (the real SMPL model is licensed and not in the repository);
* the mean parameters: camera scale 0.9, the root turned by pi about x,
  the rest zero.

Both the system under test and the reference get these tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .reference import model as ref

Params = Dict[str, torch.Tensor]


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def make_hmr(cfg: dict, seed: int, device) -> Tuple[Params, torch.Tensor]:
    """(the HMR state dict: encoder and regressor weights and BatchNorm
    buffers, the mean theta (1, 85))."""
    spec = ref.resnet_spec(cfg["encoder_stage_sizes"]) + ref.regressor_spec(
        ref.encoder_feature_dim(cfg["encoder_stage_sizes"]), cfg["ief_hidden"]
    )
    return _fill(spec, cfg, _generator(seed, device), device), mean_theta(device)


def make_critic(cfg: dict, seed: int, device) -> Params:
    return _fill(ref.critic_spec(), cfg, _generator(seed + 1, device), device)


def _fill(spec, cfg: dict, gen: torch.Generator, device) -> Params:
    random = [(n, s, k) for n, s, k in spec if k in ("conv", "dense", "dense_out")]
    total = sum(math.prod(s) for _, s, _ in random)
    draw = torch.randn(total, generator=gen, device=device)
    out: Params = {}
    at = 0
    for name, shape, kind in random:
        n = math.prod(shape)
        if kind == "conv":
            std = math.sqrt(1.0 / ref.fan_in(shape))
        elif kind == "dense":
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            std = cfg["ief_out_std"]
        out[name] = draw[at : at + n].view(shape) * std
        at += n
    for name, shape, kind in spec:
        if kind in ("bias", "bn_b", "bn_mean"):
            out[name] = torch.zeros(shape, device=device)
        elif kind in ("bn_w", "bn_var"):
            out[name] = torch.ones(shape, device=device)
        elif kind == "bn_count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return {name: out[name] for name, _, _ in spec}


def mean_theta(device) -> torch.Tensor:
    m = torch.zeros(1, ref.THETA_DIM, device=device)
    m[0, 0] = 0.9
    m[0, 3] = math.pi
    return m


def make_body(cfg: dict, seed: int, device) -> ref.Body:
    """The body model's tensors at the configuration's sizes."""
    g = _generator(seed + 2, device)
    v, k, kp = cfg["num_verts"], 24, 19
    template = torch.rand(v, 3, generator=g, device=device) * 2.0 - 1.0
    shapedirs = 0.03 * torch.randn(cfg["num_betas"], 3 * v, generator=g, device=device)
    posedirs = 0.01 * torch.randn(207, 3 * v, generator=g, device=device)
    # each regressed point: a convex combination of 8 random vertices
    order = torch.rand(k + kp, v, generator=g, device=device).argsort(dim=1)[:, :8]
    w = torch.rand(k + kp, 8, generator=g, device=device) * 0.9 + 0.1
    reg = torch.zeros(k + kp, v, device=device).scatter_(1, order, w / w.sum(1, keepdim=True)).T.contiguous()
    j_reg, kp_reg = reg[:, :k].contiguous(), reg[:, k:].contiguous()
    rest = template.T @ j_reg  # (3, 24)
    d2 = ((template[:, :, None] - rest[None]) ** 2).sum(1)
    lbs = torch.exp(-d2 / (0.5 + d2.mean()))
    lbs = lbs / lbs.sum(1, keepdim=True)
    return ref.Body(template, shapedirs, posedirs, j_reg, lbs, kp_reg)
