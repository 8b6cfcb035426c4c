"""The port's TensorFlow halves on the CPU: ``models/port_keras.py``
against Keras itself, ``cli/import_encoder.py``, and the reference
checkpoint import (``models/port_reference.py``,
``cli/import_checkpoint.py``), each held against the JAX package's port
of the same Keras models. Nothing is downloaded: Keras models are built
with ``weights=None``.

Tolerances: ported tensors exactly; the port's ResNet-50 features against
Keras's at 1e-4 (f32, 64 px); the restored ``Predictor`` against an
``HMR`` built from the same state dict exactly.
"""
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from human_pose_estimation_tpu.models import port_keras as jport_keras  # noqa: E402
from human_pose_estimation_tpu.models import port_reference as jport_reference  # noqa: E402
from human_pose_estimation_tpu_torch.config import Config  # noqa: E402
from human_pose_estimation_tpu_torch.core.smpl import save_model_npz  # noqa: E402
from human_pose_estimation_tpu_torch.models import port_keras, port_reference  # noqa: E402
from human_pose_estimation_tpu_torch.models.port_jax import flax_to_state_dict  # noqa: E402
from human_pose_estimation_tpu_torch.models.resnet import ResNet50  # noqa: E402
from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model  # noqa: E402


def _perturb_bn_stats(keras_model, seed=1):
    """Non-default BN statistics and affine parameters, as a pretrained
    model has (tests/test_resnet_parity.py's perturbation)."""
    rng = np.random.RandomState(seed)
    for v in keras_model.variables:
        arr = v.numpy()
        if "moving_variance" in v.name:
            v.assign(rng.lognormal(0.0, 1.0, arr.shape).astype(arr.dtype))
        elif "moving_mean" in v.name:
            v.assign((rng.randn(*arr.shape) * 0.5).astype(arr.dtype))
        elif "gamma" in v.name:
            v.assign((1.0 + rng.randn(*arr.shape) * 0.3).astype(arr.dtype))
        elif "beta" in v.name:
            v.assign((rng.randn(*arr.shape) * 0.3).astype(arr.dtype))


def _assert_state_equal(got, want, prefix=""):
    want = {f"{prefix}{k}": v for k, v in want.items()}
    got = {k: v for k, v in got.items() if k in want}
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


@pytest.fixture(scope="module")
def keras_rn50():
    from tensorflow.keras import applications as kapps

    model = kapps.ResNet50(include_top=False, weights=None, pooling="avg")
    _perturb_bn_stats(model)
    return model


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keras_model") / "model.npz")
    save_model_npz(synthetic_model(num_verts=120, seed=0), path)
    return path


def test_port_resnet50_matches_keras(keras_rn50):
    """Keras 3 returns a BatchNorm's weights as [gamma, beta, moving_mean,
    moving_variance], the order both ports read; the port equals the JAX
    port exactly and Keras's features within 1e-4."""
    bn = keras_rn50.get_layer("conv2_block1_1_bn")
    assert [w.name for w in bn.weights] == ["gamma", "beta", "moving_mean", "moving_variance"]
    sd = port_keras.port_resnet50(keras_rn50)
    _assert_state_equal(sd, flax_to_state_dict(*jport_keras.port_resnet50(keras_rn50)))

    encoder = ResNet50().eval()
    encoder.load_state_dict(sd)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    with torch.no_grad():
        ours = encoder(torch.from_numpy(x)).numpy()
    theirs = keras_rn50(tf.constant(x), training=False).numpy()
    assert ours.shape == theirs.shape == (2, 2048)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def keras_h5(keras_rn50, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keras_h5") / "rn50.weights.h5")
    keras_rn50.save_weights(path)
    return path


def _import_encoder(donor, keras_h5, model_path):
    from human_pose_estimation_tpu_torch.cli import import_encoder

    return import_encoder.main(
        ["--keras_weights", keras_h5, "--checkpoint_dir", donor, "--smpl_model_path", model_path,
         "--img_size", "56"],
        device="cpu",
    )


def test_import_encoder_cli_builds_a_donor_the_trainer_grafts(keras_rn50, keras_h5, model_path, tmp_path, capsys):
    """The CLI writes a step-0 donor whose encoder is the JAX port of the
    same Keras weights exactly (what the JAX CLI writes,
    tests/test_port_reference.py::test_import_encoder_cli_builds_init_donor);
    a Trainer grafted from it with --init_encoder_from holds exactly those
    weights. Run again into the same directory it writes nothing and says
    so, as the JAX CLI's Orbax manager skips the step there (silently)."""
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    donor = str(tmp_path / "donor")
    want = flax_to_state_dict(*jport_keras.port_resnet50(keras_rn50))
    _, written = _import_encoder(donor, keras_h5, model_path)
    assert written and "donor checkpoint" in capsys.readouterr().out
    raw, step = ckpt.restore_raw(donor)
    assert step == 0 and sorted(os.listdir(donor)) == ["0"]
    _assert_state_equal(raw["hmr"], want, prefix="encoder.")

    cfg = Config(smpl_model_path=model_path, checkpoint_dir=str(tmp_path / "run"), init_encoder_from=donor,
                 img_size=56, encoder_dtype="float32", model_dir=None, num_examples_override=8)
    trainer = Trainer(cfg, validation_only=True, device="cpu")
    _assert_state_equal(trainer.state.hmr.state_dict(), want, prefix="encoder.")

    mtime = os.path.getmtime(os.path.join(donor, "0", ckpt.PAYLOAD))
    _, written = _import_encoder(donor, keras_h5, model_path)
    assert not written and "wrote nothing" in capsys.readouterr().out
    assert sorted(os.listdir(donor)) == ["0"] and os.path.getmtime(os.path.join(donor, "0", ckpt.PAYLOAD)) == mtime


@pytest.mark.slow
def test_import_encoder_cli_equals_jax_cli(keras_h5, model_path, tmp_path):
    """Both packages' CLIs on the same .h5: equal encoder tensors. Slow:
    the JAX CLI builds and initializes a full JAX train state (~30 s)."""
    import jax

    from human_pose_estimation_tpu.cli import import_encoder as jimport_encoder
    from human_pose_estimation_tpu.utils import checkpoint as jckpt

    jimport_encoder.main(["--keras_weights", keras_h5, "--checkpoint_dir", str(tmp_path / "jax"),
                          "--smpl_model_path", model_path, "--img_size", "56"])
    jraw, _ = jckpt.restore_raw(str(tmp_path / "jax"))
    jraw = jax.tree.map(np.asarray, jraw)
    _import_encoder(str(tmp_path / "port"), keras_h5, model_path)
    raw, _ = ckpt.restore_raw(str(tmp_path / "port"))
    _assert_state_equal(raw["hmr"], flax_to_state_dict(jraw["gen_params"]["encoder"],
                                                       jraw["batch_stats"]["encoder"]), prefix="encoder.")


def test_port_regressor_rejects_wrong_layer_count():
    from tensorflow import keras
    from tensorflow.keras import layers

    bad = keras.Sequential([layers.Input((8,)), layers.Dense(4)])
    with pytest.raises(ValueError, match="3 weighted layers"):
        port_reference.port_regressor(bad)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference tf.train.Checkpoint written from one set of Keras
    models, which the tests keep to compare with (the import builds fresh
    ones, so a restore that leaves them at their random init fails)."""
    models = (port_reference.build_reference_encoder(), port_reference.build_reference_regressor(),
              port_reference.build_reference_critic())
    _perturb_bn_stats(models[0], seed=2)
    theta0 = (np.random.RandomState(4).randn(1, 85) * 0.1).astype(np.float32)
    ref_dir = tmp_path_factory.mktemp("ref_ckpts")
    port_reference.make_reference_checkpoint(*models, tf.Variable(theta0)).save(str(ref_dir / "ckpt"))
    return str(ref_dir), models, theta0


def test_import_reference_checkpoint_roundtrip(reference_checkpoint, model_path, tmp_path):
    """Every imported weight equals the JAX port of the source models; the
    state has mean theta = inital_theta and a fresh Adam state; a Trainer
    resumes from it and a restored Predictor serves exactly what an HMR
    loaded from the same state dict computes."""
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor
    from human_pose_estimation_tpu_torch.models.hmr import HMR
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    ref_dir, (enc_k, reg_k, critic_k), theta0 = reference_checkpoint
    out = str(tmp_path / "imported")
    # an encoder depth and stage sizes of another run: the reference's is ResNet-50 whatever they say
    cfg = Config(smpl_model_path=model_path, checkpoint_dir=out, img_size=64, encoder_dtype="float32",
                 encoder_depth=101, model_dir=None, num_examples_override=8)
    state, inital_theta, written = port_reference.import_reference_checkpoint(ref_dir, out, cfg, device="cpu")
    assert written and ckpt.latest_step(out) == 0
    np.testing.assert_array_equal(inital_theta, theta0)
    np.testing.assert_array_equal(state.mean_theta.detach().numpy(), theta0)
    raw, _ = ckpt.restore_raw(out)
    _assert_state_equal(raw["hmr"], flax_to_state_dict(*jport_keras.port_resnet50(enc_k)), prefix="encoder.")
    _assert_state_equal(raw["hmr"], flax_to_state_dict(jport_reference.port_regressor(reg_k)), prefix="regressor.")
    _assert_state_equal(raw["critic"], flax_to_state_dict(jport_reference.port_critic(critic_k)))
    assert raw["step"] == 0 and raw["gen_adam"]["step"] == raw["critic_adam"]["step"] == 0
    assert all(not v.any() for v in raw["gen_adam"]["exp_avg"].values())

    trainer = Trainer(cfg.replace(train_from_checkpoint=True, encoder_depth=50), validation_only=True, device="cpu")
    assert trainer.restore() == 0
    _assert_state_equal(trainer.state.hmr.state_dict(), raw["hmr"])

    images = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32) * 2 - 1
    pred = Predictor(cfg.replace(encoder_depth=50), batch_size=2, device="cpu")
    got = pred.predict(images)
    hmr = HMR(synthetic_model(num_verts=120, seed=0), device="cpu", encoder_dtype="float32").eval()
    hmr.load_state_dict(raw["hmr"])
    with torch.no_grad():
        stage = hmr(torch.from_numpy(images), raw["mean_theta"], smpl_stages="last")[-1]
    np.testing.assert_array_equal(got["generated_verts"], stage.verts.numpy())
    np.testing.assert_array_equal(got["theta"], stage.theta.numpy())


def test_import_checkpoint_cli(reference_checkpoint, model_path, tmp_path, capsys):
    """The CLI writes what the function writes; a second run into the same
    directory writes nothing and says so."""
    from human_pose_estimation_tpu_torch.cli import import_checkpoint

    ref_dir, (enc_k, _, _), theta0 = reference_checkpoint
    out = str(tmp_path / "cli")
    argv = ["--reference_checkpoint_dir", ref_dir, "--checkpoint_dir", out, "--smpl_model_path", model_path]
    state, inital_theta, written = import_checkpoint.main(argv, device="cpu")
    assert written and "imported reference checkpoint" in capsys.readouterr().out
    np.testing.assert_array_equal(inital_theta, theta0)
    raw, step = ckpt.restore_raw(out)
    assert step == 0
    _assert_state_equal(raw["hmr"], flax_to_state_dict(*jport_keras.port_resnet50(enc_k)), prefix="encoder.")
    _, _, written = import_checkpoint.main(argv, device="cpu")
    assert not written and "wrote nothing" in capsys.readouterr().out
