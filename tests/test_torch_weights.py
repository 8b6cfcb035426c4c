"""The port's weight paths against the JAX package's, without TensorFlow:
the s2d stem (``models/resnet.py``), the Keras ResNet port
(``models/port_keras.py``) and the reference regressor / critic ports
(``models/port_reference.py``) fed stand-in Keras models (objects with
``.layers`` / ``.get_layer`` / ``.get_weights()`` holding seeded arrays in
Keras's layer names and shapes), and ``utils/assets.write_reference_pickle``.

Ports only move data, so ported tensors are compared exactly. Features of
an encoder are compared at 1e-5 relative to their largest magnitude (f32;
the random stand-in weights do not keep the deep encoders' features O(1)).
The TensorFlow halves are in ``tests/test_torch_keras.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.models import port_keras as jport_keras
from human_pose_estimation_tpu.models import port_reference as jport_reference
from human_pose_estimation_tpu.models import resnet as jresnet
from human_pose_estimation_tpu.utils import assets as jassets
from human_pose_estimation_tpu_torch.core import smpl as tsmpl
from human_pose_estimation_tpu_torch.models import port_keras, port_reference, resnet
from human_pose_estimation_tpu_torch.models.critic import Critic
from human_pose_estimation_tpu_torch.models.port_jax import flax_to_state_dict
from human_pose_estimation_tpu_torch.models.regressor import IEFRegressor
from human_pose_estimation_tpu_torch.utils import assets as tassets


class Layer:
    """A Keras layer as the ports read it: a name and its weights."""

    def __init__(self, name, weights=()):
        self.name, self._weights = name, [np.asarray(w, np.float32) for w in weights]

    def get_weights(self):
        return list(self._weights)


class Model:
    def __init__(self, layers):
        self.layers = layers

    def get_layer(self, name):
        return next(layer for layer in self.layers if layer.name == name)


def keras_resnet(depth, rng):
    """keras.applications.ResNet{depth}(include_top=False)'s weighted
    layers in its names and shapes (conv kernels HWIO; BN [gamma, beta,
    moving_mean, moving_variance]), with weightless layers between them."""
    layers = [Layer("input_layer"), Layer("conv1_pad")]

    def conv(name, k, cin, cout):
        layers.append(Layer(name, [rng.randn(k, k, cin, cout) * np.sqrt(1.0 / (k * k * cin)), rng.randn(cout) * 0.1]))

    def bn(name, c):
        layers.append(Layer(name, [1 + 0.2 * rng.randn(c), 0.2 * rng.randn(c), 0.2 * rng.randn(c),
                                   rng.lognormal(0.0, 0.3, c)]))
        layers.append(Layer(name.replace("_bn", "_relu")))

    conv("conv1_conv", 7, 3, 64)
    bn("conv1_bn", 64)
    layers.append(Layer("pool1_pool"))
    cin = 64
    for stage, blocks in port_keras.DEPTH_STAGE_BLOCKS[depth].items():
        f = 64 * 2 ** (stage - 1)
        for b in range(1, blocks + 1):
            p = f"conv{stage + 1}_block{b}"
            if b == 1:
                conv(f"{p}_0_conv", 1, cin, 4 * f)
                bn(f"{p}_0_bn", 4 * f)
            for i, (k, ci, co) in enumerate(((1, cin, f), (3, f, f), (1, f, 4 * f)), start=1):
                conv(f"{p}_{i}_conv", k, ci, co)
                bn(f"{p}_{i}_bn", co)
            layers.append(Layer(f"{p}_add"))
            cin = 4 * f
    layers.append(Layer("avg_pool"))
    return Model(layers)


def keras_dense(name, rng, n_in, n_out):
    return Layer(name, [rng.randn(n_in, n_out) / np.sqrt(n_in), rng.randn(n_out) * 0.1])


def keras_regressor(rng):
    return Model([keras_dense("dense", rng, 2133, 1024), Layer("dropout"), keras_dense("dense_1", rng, 1024, 1024),
                  Layer("dropout_1"), keras_dense("dense_2", rng, 1024, 85)])


CRITIC_SHAPES = {
    "kcs_dense": (169, 100), "joints_dense": (42, 100), "combined_dense": (200, 1), "shapes_dense_1": (10, 10),
    "shapes_dense_2": (10, 5), "shapes_dense_3": (5, 1), "rotation_dense_1": (207, 300),
    "rotation_dense_2": (300, 100), "rotation_dense_3": (100, 1),
}


def keras_critic(rng):
    return Model([Layer("kcs_in")] + [keras_dense(n, rng, *s) for n, s in CRITIC_SHAPES.items()])


def assert_state_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def assert_features(out, ref, tol=1e-5):
    ref = np.asarray(ref)
    out = out.detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the s2d stem


def test_s2d_transforms_equal_jax(rng):
    """space_to_depth_2x2 and conv1_kernel_to_s2d move the same elements
    as JAX's (layouts transposed: OIHW here, HWIO there)."""
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(resnet.space_to_depth_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jresnet.space_to_depth_2x2(jnp.asarray(x))))
    w7 = rng.randn(7, 7, 3, 64).astype(np.float32)  # HWIO
    ref = np.asarray(jresnet.conv1_kernel_to_s2d(jnp.asarray(w7))).transpose(3, 2, 0, 1)
    out = resnet.conv1_kernel_to_s2d(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy())).numpy()
    assert out.shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="even"):
        resnet.space_to_depth_2x2(torch.zeros(1, 7, 8, 3))
    with pytest.raises(ValueError, match="stem"):
        resnet.ResNet((1, 1, 1, 1), stem="s4d")


def test_s2d_stem_equals_standard_stem_and_jax():
    """On the same weights the s2d stem computes the standard stem's
    features (atol 1e-5, as tests/test_resnet_parity.py holds JAX's), and
    the port's s2d ResNet equals JAX's on bridged weights (1e-5 of the
    largest feature)."""
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    jstd = jresnet.ResNet(stage_sizes=(1, 1, 1, 1))
    variables = jax.tree.map(np.asarray, jstd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jparams_s2d = jax.tree.map(np.asarray, jresnet.convert_params_to_s2d(dict(variables["params"])))
    ref = jresnet.ResNet(stage_sizes=(1, 1, 1, 1), stem="s2d").apply(
        {"params": jparams_s2d, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=False
    )

    sd = flax_to_state_dict(variables["params"], variables["batch_stats"])
    std = resnet.ResNet((1, 1, 1, 1)).eval()
    std.load_state_dict(sd)
    s2d = resnet.ResNet((1, 1, 1, 1), stem="s2d").eval()
    converted = resnet.convert_params_to_s2d(sd)
    assert torch.equal(converted["conv1.weight"],
                       flax_to_state_dict(jparams_s2d, variables["batch_stats"])["conv1.weight"])
    assert all(converted[k] is v for k, v in sd.items() if k != "conv1.weight")
    s2d.load_state_dict(converted)
    with torch.no_grad():
        out_std, out_s2d = std(torch.from_numpy(x)), s2d(torch.from_numpy(x))
    np.testing.assert_allclose(out_s2d.numpy(), out_std.numpy(), atol=1e-5)
    assert_features(out_s2d, ref)


def test_resnet50_alias_and_s2d_depths():
    assert resnet.ResNet50().stage_sizes == resnet.STAGE_SIZES[50] == jresnet.STAGE_SIZES[50]
    for depth in (50, 101, 152):
        model = resnet.make_resnet(depth, stem="s2d")
        assert model.stem == "s2d" and tuple(model.conv1.weight.shape) == (64, 12, 4, 4)
        assert model.stage_sizes == jresnet.STAGE_SIZES[depth]
    with pytest.raises(ValueError):
        resnet.make_resnet(34)


# ---------------------------------------------------------------------------
# the Keras ResNet port


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_port_resnet_matches_jax(depth):
    """A stand-in keras.applications.ResNet{depth} through both ports:
    the port's state dict is the JAX tree's exactly, and the encoder's
    features on it equal the JAX encoder's (2 images at 32 px)."""
    keras_model = keras_resnet(depth, np.random.RandomState(depth))
    jparams, jstats = jport_keras.port_resnet(keras_model, depth=depth)
    sd = port_keras.port_resnet50(keras_model) if depth == 50 else port_keras.port_resnet(keras_model, depth=depth)
    assert_state_equal(sd, flax_to_state_dict(jparams, jstats))
    assert port_keras.DEPTH_STAGE_BLOCKS == jport_keras.DEPTH_STAGE_BLOCKS
    assert port_keras.STAGE_BLOCKS == jport_keras.STAGE_BLOCKS

    encoder = resnet.make_resnet(depth).eval()
    encoder.load_state_dict(sd)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    ref = jresnet.make_resnet(depth).apply({"params": jparams, "batch_stats": jstats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        assert_features(encoder(torch.from_numpy(x)), ref)


# ---------------------------------------------------------------------------
# the reference regressor and critic ports


def test_port_regressor_and_critic_match_jax():
    rng = np.random.RandomState(3)
    regressor_k, critic_k = keras_regressor(rng), keras_critic(rng)
    sd = port_reference.port_regressor(regressor_k)
    assert_state_equal(sd, flax_to_state_dict(jport_reference.port_regressor(regressor_k)))
    IEFRegressor().load_state_dict(sd)  # strict: every name and shape of the module
    sd = port_reference.port_critic(critic_k)
    assert_state_equal(sd, flax_to_state_dict(jport_reference.port_critic(critic_k)))
    Critic().load_state_dict(sd)
    assert port_reference.CRITIC_DENSE_NAMES == jport_reference.CRITIC_DENSE_NAMES

    with pytest.raises(ValueError, match="3 weighted layers"):
        port_reference.port_regressor(Model([keras_dense("dense", rng, 8, 4)]))


# ---------------------------------------------------------------------------
# utils/assets.write_reference_pickle


def test_write_reference_pickle_matches_jax(tmp_path, tiny_model):
    """The port's and the JAX package's pickles of the same model load
    into equal arrays through the port's loader."""
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jassets.write_reference_pickle(tiny_model, jpath)
    tassets.write_reference_pickle(tassets.synthetic_model(num_verts=120, seed=0), tpath)
    a, b = tsmpl.load_model(jpath), tsmpl.load_model(tpath)
    for k in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "joint_regressor"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.parents == b.parents == tuple(tiny_model.parents)
    np.testing.assert_array_equal(a.faces, b.faces)
