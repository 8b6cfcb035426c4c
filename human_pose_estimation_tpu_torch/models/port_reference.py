"""Import a trained *reference* tf.train.Checkpoint into this package
(counterpart of ``human_pose_estimation_tpu/models/port_reference.py``).

A checkpoint written by the reference Trainer (or its Predictor's
identical bundle) becomes a step-0 checkpoint in the ``utils/checkpoint.py``
layout, which ``Trainer(train_from_checkpoint=True)`` and ``Predictor``
restore. The reference bundle's object graph:

  generator_optimizer / discriminator_optimizer   keras Adam (slots skipped)
  feature_extractor   keras ResNet50(include_top=False, pooling='avg')
  generator3d         Sequential 2133 -> 1024 -> drop -> 1024 -> drop -> 85
  discriminator       3-stream functional critic
  inital_theta [sic]  (1, 85) initial mean-theta variable

The ``build_reference_*`` functions rebuild that graph under TensorFlow /
Keras (imported inside them); ``restore_reference_checkpoint`` restores a
checkpoint into it. The ports (``port_regressor``, ``port_critic``,
``import_reference_models``) take Keras models or any objects with the
same ``.layers`` / ``.get_layer`` / ``.get_weights()`` and need no
TensorFlow.

As in the JAX package: ``inital_theta`` is the only mean theta any restore
can recover (the reference never checkpoints the one it trains), the
optimizer moments are not imported (a fresh Adam state), and the encoder
is always ResNet-50.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .port_jax import flax_to_state_dict

__all__ = [
    "CRITIC_DENSE_NAMES",
    "build_reference_critic",
    "build_reference_encoder",
    "build_reference_regressor",
    "import_reference_checkpoint",
    "import_reference_models",
    "make_reference_checkpoint",
    "port_critic",
    "port_regressor",
    "restore_reference_checkpoint",
]

CRITIC_DENSE_NAMES = (
    "kcs_dense",
    "joints_dense",
    "combined_dense",
    "shapes_dense_1",
    "shapes_dense_2",
    "shapes_dense_3",
    "rotation_dense_1",
    "rotation_dense_2",
    "rotation_dense_3",
)


# ---------------------------------------------------------------------------
# Reference network graphs (reconstructed, not imported from the reference)
# ---------------------------------------------------------------------------


def build_reference_encoder():
    """The reference encoder graph, without the ImageNet download (the
    weights come from the checkpoint)."""
    from tensorflow.keras.applications import ResNet50

    return ResNet50(include_top=False, weights=None, pooling="avg")


def build_reference_regressor(num_input: int = 2133, num_output: int = 85):
    """The reference regressor graph."""
    from tensorflow import keras
    from tensorflow.keras import layers

    return keras.Sequential(
        [
            layers.Input((num_input,)),
            layers.Dense(1024, activation="relu"),
            layers.Dropout(0.5),
            layers.Dense(1024, activation="relu"),
            layers.Dropout(0.5),
            layers.Dense(num_output),
        ]
    )


def build_reference_critic():
    """The reference critic graph, with ``keras.layers.Concatenate`` where
    the reference's ``tf.concat`` no longer builds under Keras 3; layer
    names, sizes, activations and flatten order are the reference's."""
    import tensorflow as tf
    from tensorflow import keras
    from tensorflow.keras import layers

    kcs_in = layers.Input((13, 13), name="kcs_in")
    kcs = layers.Dense(100, activation=tf.nn.leaky_relu, name="kcs_dense")(layers.Flatten()(kcs_in))
    joints_in = layers.Input((14, 3))
    joints = layers.Dense(100, activation=tf.nn.leaky_relu, name="joints_dense")(layers.Flatten()(joints_in))
    skel = layers.Dense(1, name="combined_dense")(layers.Concatenate(axis=1)([kcs, joints]))
    shapes_in = layers.Input((10,))
    s = layers.Dense(10, activation="relu", name="shapes_dense_1")(shapes_in)
    s = layers.Dense(5, activation="relu", name="shapes_dense_2")(s)
    s = layers.Dense(1, name="shapes_dense_3")(s)
    rot_in = layers.Input((23, 3, 3), name="rotation_in")
    r = layers.Flatten()(rot_in)
    r = layers.Dense(300, activation=tf.nn.leaky_relu, name="rotation_dense_1")(r)
    r = layers.Dense(100, activation=tf.nn.leaky_relu, name="rotation_dense_2")(r)
    r = layers.Dense(1, name="rotation_dense_3")(r)
    out = layers.Concatenate(axis=1)([skel, s, r])
    return keras.Model(inputs=[kcs_in, joints_in, shapes_in, rot_in], outputs=out)


def make_reference_checkpoint(encoder, regressor, critic, inital_theta):
    """The reference's tf.train.Checkpoint object graph with its exact
    attribute names, the ``inital_theta`` typo included: it is part of the
    on-disk key space."""
    import tensorflow as tf

    return tf.train.Checkpoint(
        generator_optimizer=tf.keras.optimizers.Adam(0.0),
        discriminator_optimizer=tf.keras.optimizers.Adam(0.0),
        feature_extractor=encoder,
        generator3d=regressor,
        discriminator=critic,
        inital_theta=inital_theta,
    )


def restore_reference_checkpoint(checkpoint_dir: str):
    """Rebuild the reference object graph and restore the latest
    checkpoint of ``checkpoint_dir`` into it. Returns (encoder, regressor,
    critic, inital_theta as a (1, 85) ndarray)."""
    import tensorflow as tf

    encoder = build_reference_encoder()
    regressor = build_reference_regressor()
    critic = build_reference_critic()
    theta_var = tf.Variable(np.zeros((1, 85), np.float32))
    ckpt = make_reference_checkpoint(encoder, regressor, critic, theta_var)
    latest = tf.train.latest_checkpoint(checkpoint_dir)
    if latest is None:
        raise FileNotFoundError(f"no reference checkpoint under {checkpoint_dir}")
    ckpt.restore(latest).expect_partial()
    return encoder, regressor, critic, theta_var.numpy()


# ---------------------------------------------------------------------------
# Keras -> state dict ports
# ---------------------------------------------------------------------------


def _dense(kernel, bias) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(kernel), "bias": np.asarray(bias)}


def port_regressor(keras_model) -> Dict[str, torch.Tensor]:
    """Sequential Dense(1024) / Dense(1024) / Dense(85) -> the state dict of
    ``models.regressor.IEFRegressor`` (fc1, fc2, out; the Dropout layers
    carry no weights)."""
    dense = [layer for layer in keras_model.layers if layer.get_weights()]
    if len(dense) != 3:
        raise ValueError(f"expected 3 weighted layers in the regressor, got {len(dense)}")
    return flax_to_state_dict({name: _dense(*layer.get_weights()) for name, layer in zip(("fc1", "fc2", "out"), dense)})


def port_critic(keras_model) -> Dict[str, torch.Tensor]:
    """Name-for-name Dense port onto ``models.critic.Critic`` (the same
    layer names; both flatten row-major)."""
    return flax_to_state_dict(
        {name: _dense(*keras_model.get_layer(name).get_weights()) for name in CRITIC_DENSE_NAMES}
    )


# ---------------------------------------------------------------------------
# Full import
# ---------------------------------------------------------------------------


def import_reference_models(encoder, regressor, critic, inital_theta, out_dir: str, config, device=None):
    """The TensorFlow-free half of the import: the reference's models (or
    stand-ins with their layer names and weights) and its ``inital_theta``
    -> a fresh training state (ResNet-50, whatever ``encoder_depth`` says,
    as the reference's encoder is) holding their weights, with
    ``mean_theta`` = ``inital_theta`` and a fresh Adam state, saved at step
    0 under ``out_dir``. Returns (state, whether the step was written: a
    directory that already holds a step at or above 0 is not written to).
    Runs on ``cuda`` unless ``device`` says otherwise."""
    from ..core.smpl import load_model
    from ..train.state import create_train_state
    from ..utils.checkpoint import save_train_state
    from .port_keras import port_resnet50

    theta = np.asarray(inital_theta, np.float32).reshape(1, 85)
    cfg = config.replace(encoder_depth=50, encoder_stage_sizes="")
    state = create_train_state(load_model(cfg.smpl_model_path), theta, cfg, device=device, seed=cfg.seed)
    state.hmr.encoder.load_state_dict(port_resnet50(encoder))
    state.hmr.regressor.load_state_dict(port_regressor(regressor))
    state.critic.load_state_dict(port_critic(critic))
    return state, save_train_state(out_dir, state, step=0)


def import_reference_checkpoint(checkpoint_dir: str, out_dir: str, config, device=None) -> Tuple[object, np.ndarray, bool]:
    """Convert a reference checkpoint (needs TensorFlow) into a step-0
    checkpoint under ``out_dir`` that ``Trainer(train_from_checkpoint=True)``
    and ``Predictor`` restore. Returns (state, inital_theta, whether the
    step was written): as with the JAX package's Orbax manager, a directory
    that already holds a step at or above 0 is left as it is."""
    encoder, regressor, critic, inital_theta = restore_reference_checkpoint(checkpoint_dir)
    state, written = import_reference_models(encoder, regressor, critic, inital_theta, out_dir, config, device)
    return state, inital_theta, written
