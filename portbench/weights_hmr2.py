"""HMR 2.0's weights made from the seed, on the device, in float32 (the type
the parameters are kept in; the model computes in bfloat16 under
autocast), as ``weights.py`` makes the ResNet's: every random tensor comes
from one draw of a generator on the device, cut into leaves and scaled.

* the ViT (ViTPose's initialiser): dense layers and the position
  embedding normal, std ``vit_std`` (0.02; timm's truncation at +-2 never
  binds there), the patch convolution LeCun normal, std sqrt(1 / fan_in),
  zero biases, LayerNorm scale 1 and offset 0;
* the head: dense layers and the token embedding Glorot normal, std
  sqrt(2 / (fan_in + fan_out)), the learned position std ``vit_std``, the
  three read-outs std ``head_out_std`` (a small first step from the mean,
  as the IEF's output layer), zero biases, LayerNorm 1 and 0.

The critic, the body model and the mean theta are ``weights.py``'s.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .reference import hmr2 as ref
from .weights import Params, _generator, mean_theta

_RANDOM = ("patch", "vit_dense", "pos", "token", "dense", "dense_out", "head_pos")


def make_hmr2(cfg: dict, seed: int, device) -> Tuple[Params, torch.Tensor]:
    """(the HMR state dict: the ViT's and the head's weights, the mean theta
    (1, 85))."""
    spec = ref.vit_spec(cfg) + ref.head_spec(cfg)
    random = [(n, s, k) for n, s, k in spec if k in _RANDOM]
    draw = torch.randn(sum(math.prod(s) for _, s, _ in random), generator=_generator(seed, device), device=device)
    std = {"vit_dense": cfg["vit_std"], "pos": cfg["vit_std"], "head_pos": cfg["vit_std"],
           "dense_out": cfg["head_out_std"]}
    out: Params = {}
    at = 0
    for name, shape, kind in random:
        n = math.prod(shape)
        if kind == "patch":
            s = math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind in ("dense", "token"):
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
    return {name: out[name] for name, _, _ in spec}, mean_theta(device)
