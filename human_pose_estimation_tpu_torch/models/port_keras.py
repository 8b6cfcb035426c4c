"""Keras ResNet -> encoder state dict (counterpart of
``human_pose_estimation_tpu/models/port_keras.py``).

Maps ``keras.applications.ResNet{50,101,152}`` weights (the reference's
ImageNet encoder initialisation, ``ResNet50(include_top=False,
weights='imagenet', pooling='avg')``) onto ``models/resnet.py``'s
``make_resnet(depth)``. Keras layer name -> module name:

  conv1_conv / conv1_bn                 -> conv1 / bn1
  conv{s+1}_block{b}_0_conv (shortcut)  -> stage{s}_block{b}.conv_sc
  conv{s+1}_block{b}_{i}_conv (i=1..3)  -> stage{s}_block{b}.conv{i}
  (BatchNorms alike: [gamma, beta, moving_mean, moving_variance] ->
  weight, bias, running_mean, running_var)

Keras kernels are HWIO, as Flax's, so the walk builds the JAX package's
nested numpy tree and hands it to ``models/port_jax.flax_to_state_dict``,
which holds the one place of the transposes. TensorFlow is imported only
by ``load_imagenet_resnet``; the port functions take any object with
``.layers``, each with ``.name`` and ``.get_weights()``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .port_jax import flax_to_state_dict

__all__ = [
    "DEPTH_STAGE_BLOCKS",
    "STAGE_BLOCKS",
    "load_imagenet_resnet",
    "load_imagenet_resnet50",
    "port_resnet",
    "port_resnet50",
]

STAGE_BLOCKS = {1: 3, 2: 4, 3: 6, 4: 3}  # ResNet-50

DEPTH_STAGE_BLOCKS = {
    50: {1: 3, 2: 4, 3: 6, 4: 3},
    101: {1: 3, 2: 4, 3: 23, 4: 3},
    152: {1: 3, 2: 8, 3: 36, 4: 3},
}


def _flax_tree(keras_model, depth: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) in the JAX package's ResNet tree, as numpy."""
    w = {layer.name: layer.get_weights() for layer in keras_model.layers}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(p, s, name, keras_name):
        if keras_name.endswith("_conv"):
            kernel, bias = w[keras_name]
            p[name] = {"kernel": np.asarray(kernel), "bias": np.asarray(bias)}
        else:
            gamma, beta, mean, var = w[keras_name]
            p[name] = {"scale": np.asarray(gamma), "bias": np.asarray(beta)}
            s[name] = {"mean": np.asarray(mean), "var": np.asarray(var)}

    put(params, stats, "conv1", "conv1_conv")
    put(params, stats, "bn1", "conv1_bn")
    for stage, blocks in DEPTH_STAGE_BLOCKS[depth].items():
        for b in range(1, blocks + 1):
            prefix = f"conv{stage + 1}_block{b}"
            sub_p: Dict[str, Any] = {}
            sub_s: Dict[str, Any] = {}
            if b == 1:
                put(sub_p, sub_s, "conv_sc", f"{prefix}_0_conv")
                put(sub_p, sub_s, "bn_sc", f"{prefix}_0_bn")
            for i in (1, 2, 3):
                put(sub_p, sub_s, f"conv{i}", f"{prefix}_{i}_conv")
                put(sub_p, sub_s, f"bn{i}", f"{prefix}_{i}_bn")
            params[f"stage{stage}_block{b}"] = sub_p
            stats[f"stage{stage}_block{b}"] = sub_s
    return params, stats


def port_resnet(keras_model, depth: int = 50) -> Dict[str, torch.Tensor]:
    """keras.applications.ResNet{50,101,152} weights (the same layer
    naming at every depth) -> the state dict of ``make_resnet(depth)``."""
    if depth not in DEPTH_STAGE_BLOCKS:
        raise ValueError(f"encoder depth must be one of {sorted(DEPTH_STAGE_BLOCKS)}")
    return flax_to_state_dict(*_flax_tree(keras_model, depth))


def port_resnet50(keras_model) -> Dict[str, torch.Tensor]:
    return port_resnet(keras_model, depth=50)


def load_imagenet_resnet(depth: int = 50, weights="imagenet") -> Dict[str, torch.Tensor]:
    """Build keras.applications.ResNet{depth} (needs TensorFlow; 'imagenet'
    downloads, a local .h5 path does not, None is Keras's random init) and
    port it."""
    from tensorflow.keras import applications as kapps

    ctor = {50: kapps.ResNet50, 101: kapps.ResNet101, 152: kapps.ResNet152}[depth]
    return port_resnet(ctor(include_top=False, weights=weights, pooling="avg"), depth=depth)


def load_imagenet_resnet50(weights="imagenet") -> Dict[str, torch.Tensor]:
    return load_imagenet_resnet(depth=50, weights=weights)
