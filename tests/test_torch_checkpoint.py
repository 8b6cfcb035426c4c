"""The port's checkpoints (``utils/checkpoint.py``, ``utils/orbax_import.py``,
``TrainState.state_dict``) on the CPU at a small size (encoder (1, 1, 1, 1),
56 px, P=256):

* state_dict -> save -> restore is bit-equal for every tensor, Adam count
  and schedule position; input_state.json round-trips; five steps are
  kept; a step at or below the latest is not written;
* restore_for_inference is schedule-agnostic and refuses a foreign
  checkpoint, in this package's layout and in the JAX package's;
* the Orbax importer reads a JAX ``TrainState`` saved by the JAX package
  exactly as ``train_state_from_jax`` converts it in memory, and a
  ``Predictor`` restored from that directory matches the JAX ``Predictor``
  restored from it within 1e-4 (f32).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.infer.predictor import Predictor as JPredictor
from human_pose_estimation_tpu.models.critic import Critic as JCritic
from human_pose_estimation_tpu.models.hmr import HMR as JHMR
from human_pose_estimation_tpu.train.state import create_train_state as jcreate_train_state
from human_pose_estimation_tpu.train.state import make_optimizers as jmake_optimizers
from human_pose_estimation_tpu.utils import checkpoint as jckpt
from human_pose_estimation_tpu.utils.assets import synthetic_mean_params
from human_pose_estimation_tpu_torch import pin_f32_numerics
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.core.smpl import smpl_forward
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models import port_jax
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.train.state import create_train_state
from human_pose_estimation_tpu_torch.train.step import GenBatch, MocapBatch, make_train_step
from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt
from human_pose_estimation_tpu_torch.utils import orbax_import
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

IMG = 56
BATCH = 4
NSIL = 256
STAGES = (1, 1, 1, 1)


def _cfg(**kw):
    base = dict(
        img_size=IMG, batch_size=BATCH, encoder_dtype="float32", encoder_stage_sizes="1,1,1,1",
        use_mesh_repro_loss=True, max_silhouette_points=NSIL,
    )
    base.update(kw)
    return Config(**base)


def _batch(gen, smpl):
    images = torch.rand(BATCH, IMG, IMG, 3, generator=gen) * 2 - 1
    pts = torch.randint(0, IMG, (BATCH, NSIL, 2), generator=gen).float()
    mask = (torch.arange(NSIL)[None] < torch.tensor([[200], [37], [0], [256]])).float()
    kp = torch.rand(BATCH, 19, 3, generator=gen) * 2 - 1
    kp[..., 2] = (torch.rand(BATCH, 19, generator=gen) > 0.2).float()
    pose = torch.randn(3 * BATCH, 72, generator=gen) * 0.2
    shape = torch.randn(3 * BATCH, 10, generator=gen) * 0.4
    with torch.no_grad():
        out = smpl_forward(smpl, shape, pose, joint_type="cocoplus")
    return GenBatch(images, pts * mask[..., None], mask, kp), MocapBatch(out.joints, shape, out.rotations[:, 1:])


def _trained_state(cfg, steps=2, seed=0):
    """A port state after ``steps`` training steps: moments, counts and
    schedules past their start."""
    smpl = synthetic_model(num_verts=120, seed=0)
    state = create_train_state(smpl, synthetic_mean_params()[None], cfg, device="cpu", seed=seed)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(state, *_batch(gen, smpl), gen)
    return state


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b))[:5])
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("schedule,decay", [("constant", 0), ("cosine", 10)])
def test_state_dict_save_restore_is_bit_equal(tmp_path, schedule, decay):
    cfg = _cfg(lr_schedule=schedule, lr_decay_steps=decay)
    state = _trained_state(cfg)
    saved = state.state_dict()
    assert saved["step"] == 2 and saved["gen_adam"]["step"] == 2 and saved["critic_adam"]["step"] == 2
    assert ckpt.save_train_state(str(tmp_path / "ck"), state)
    assert os.path.isfile(tmp_path / "ck" / "2" / ckpt.PAYLOAD)

    fresh = create_train_state(synthetic_model(num_verts=120, seed=0), synthetic_mean_params()[None], cfg,
                               device="cpu", seed=5)
    restored, step = ckpt.restore_train_state(str(tmp_path / "ck"), fresh)
    assert step == 2 and restored is fresh and fresh.step == 2
    _assert_tree_equal(fresh.state_dict(), saved)
    for a, b in ((fresh.gen_sched, state.gen_sched), (fresh.critic_sched, state.critic_sched)):
        assert a.last_epoch == b.last_epoch == 2
        assert a.get_last_lr() == b.get_last_lr()
    for a, b in ((fresh.gen_opt, state.gen_opt), (fresh.critic_opt, state.critic_opt)):
        assert [g["lr"] for g in a.param_groups] == [g["lr"] for g in b.param_groups]
        steps = {float(s["step"]) for s in a.state.values()}
        assert steps == {2.0}


def test_input_state_max_to_keep_and_stale_steps(tmp_path):
    cfg = _cfg()
    state = _trained_state(cfg, steps=0)
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None and ckpt.restore_input_state(d) is None
    for s in range(1, 8):
        assert ckpt.save_train_state(d, state, step=s, input_state={"image": {"pos": np.int64(s)}, "mocap": None})
    assert sorted(os.listdir(d)) == ["3", "4", "5", "6", "7"]  # max_to_keep=5, no temporary left
    assert ckpt.latest_step(d) == 7
    assert ckpt.restore_input_state(d) == {"image": {"pos": 7}, "mocap": None}
    assert ckpt.restore_input_state(d, 4) == {"image": {"pos": 4}, "mocap": None}
    # as Orbax's manager: a step at or below the latest is not written
    assert not ckpt.save_train_state(d, state, step=7)
    assert not ckpt.save_train_state(d, state, step=2)
    assert sorted(os.listdir(d)) == ["3", "4", "5", "6", "7"]
    raw, step = ckpt.restore_raw(d, 5)
    assert step == 5 and raw["step"] == 0
    with pytest.raises(FileNotFoundError):
        ckpt.restore_raw(str(tmp_path / "empty"))


_JAX_STATES = {}


def _jax_state(tiny_model, schedule="constant", decay=0):
    """A JAX train state after one optax update of each Adam on seeded
    gradients, so that the moments and counts are not the initial ones.
    Built once per schedule (the state is immutable), under ``jax.jit``:
    eager, it takes tens of seconds."""
    if (schedule, decay) not in _JAX_STATES:
        jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=STAGES)
        mean = synthetic_mean_params()[None, :]
        state = jax.jit(
            lambda key: jcreate_train_state(key, jhmr, JCritic(), mean, 1e-4, 5e-4, img_size=IMG,
                                            lr_schedule=schedule, lr_decay_steps=decay)
        )(jax.random.PRNGKey(0))
        gen_tx, critic_tx = jmake_optimizers(1e-4, 5e-4, schedule, decay)
        rng = np.random.RandomState(3)
        grads = lambda tree: jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype), tree)
        _, gen_opt = jax.jit(gen_tx.update)(grads(state.gen_params), state.gen_opt, state.gen_params)
        _, critic_opt = jax.jit(critic_tx.update)(grads(state.critic_params), state.critic_opt, state.critic_params)
        _JAX_STATES[schedule, decay] = state.replace(gen_opt=gen_opt, critic_opt=critic_opt,
                                                     step=jnp.asarray(1, jnp.int32))
    return _JAX_STATES[schedule, decay]


@pytest.mark.parametrize("layout", ["torch", "orbax"])
@pytest.mark.parametrize("schedule,decay", [("constant", 0), ("cosine", 10)])
def test_restore_for_inference_is_schedule_agnostic(tmp_path, tiny_model, layout, schedule, decay):
    d = str(tmp_path / "ck")
    if layout == "torch":
        state = _trained_state(_cfg(lr_schedule=schedule, lr_decay_steps=decay), steps=1)
        ckpt.save_train_state(d, state, step=3)
        want_hmr, want_mean = state.hmr.state_dict(), state.mean_theta.detach()
    else:
        state = _jax_state(tiny_model, schedule, decay)
        jckpt.save_train_state(d, state, step=3)
        sd = port_jax.train_state_from_jax(jax.tree.map(np.asarray, state))
        want_hmr, want_mean = sd["hmr"], sd["mean_theta"]
    # the serving config does not carry the training schedule
    cfg = _cfg(checkpoint_dir=d)
    hmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu")
    variables, mean_theta = ckpt.restore_for_inference(d, hmr, cfg)
    _assert_tree_equal(dict(variables), dict(want_hmr))
    np.testing.assert_array_equal(mean_theta, want_mean.numpy().reshape(1, -1))


def test_restore_for_inference_without_a_checkpoint_starts_from_the_seed(tmp_path):
    """Without a checkpoint the weights are the seeded model's own, and a
    Predictor serves HMR(seed=config.seed)'s init with the config's mean."""
    cfg = _cfg(checkpoint_dir=str(tmp_path / "none"), seed=4)
    seeded = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu", seed=4)
    variables, mean_theta = ckpt.restore_for_inference(cfg.checkpoint_dir, seeded, cfg)
    _assert_tree_equal(dict(variables), dict(seeded.state_dict()))
    assert mean_theta.shape == (1, 85) and mean_theta[0, 0] == np.float32(0.9)
    served = Predictor(cfg, smpl=synthetic_model(num_verts=120, seed=0), device="cpu")
    _assert_tree_equal(dict(served.hmr.state_dict()), dict(seeded.state_dict()))
    assert torch.equal(served.mean_theta, torch.from_numpy(mean_theta))
    other = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu", seed=0)
    assert not torch.equal(other.state_dict()["regressor.fc1.weight"], served.hmr.state_dict()["regressor.fc1.weight"])


@pytest.mark.parametrize("layout", ["torch", "orbax", "neither"])
def test_restore_for_inference_rejects_foreign_checkpoint(tmp_path, layout):
    d = tmp_path / "ck"
    if layout == "orbax":
        jckpt.save_train_state(str(d), {"not_a": np.zeros(3), "train_state": np.ones(2)}, step=0)
        match = "no generator subtree"
    elif layout == "torch":
        os.makedirs(d / "0")
        torch.save({"not_a": torch.zeros(3)}, d / "0" / ckpt.PAYLOAD)
        match = "no generator subtree"
    else:
        os.makedirs(d / "0")
        (d / "0" / "notes.txt").write_text("not a checkpoint")
        match = "neither layout"
    hmr = HMR(synthetic_model(num_verts=30), encoder_stage_sizes=STAGES, device="cpu")
    with pytest.raises(ValueError, match=match):
        ckpt.restore_for_inference(str(d), hmr, _cfg(checkpoint_dir=str(d)))


@pytest.mark.parametrize("schedule,decay", [("constant", 0), ("cosine", 10)])
def test_orbax_import_equals_train_state_from_jax(tmp_path, tiny_model, schedule, decay):
    state = _jax_state(tiny_model, schedule, decay)
    d = str(tmp_path / "ck")
    jckpt.save_train_state(d, state, step=7)
    step_dir = os.path.join(d, "7")
    assert orbax_import.is_orbax_step(step_dir)
    want = port_jax.train_state_from_jax(jax.tree.map(np.asarray, state))
    got = orbax_import.train_state_from_orbax(step_dir)
    _assert_tree_equal(got, want)
    assert got["gen_adam"]["step"] == 1 and got["step"] == 1
    # the plain tree keeps optax's chain as a list ([adam, schedule or None])
    tree = orbax_import.read_orbax_tree(step_dir)
    assert isinstance(tree["gen_opt"], list) and len(tree["gen_opt"]) == 2
    assert (tree["gen_opt"][1] is None) == (schedule == "constant")

    # and the port's restore takes the directory as it takes its own
    port_state = create_train_state(synthetic_model(num_verts=120, seed=0), synthetic_mean_params()[None],
                                    _cfg(lr_schedule=schedule, lr_decay_steps=decay), device="cpu", seed=3)
    _, step = ckpt.restore_train_state(d, port_state)
    assert step == 7 and port_state.step == 1
    _assert_tree_equal(port_state.state_dict(), want)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, tiny_model):
    state = _jax_state(tiny_model)  # the Predictor reads only the weights
    d = str(tmp_path_factory.mktemp("jax_ck") / "ck")
    jckpt.save_train_state(d, state, step=0)
    return d


def test_predictor_restored_from_jax_checkpoint_matches_jax(jax_checkpoint, tiny_model, rng):
    pin_f32_numerics()
    kw = dict(img_size=IMG, batch_size=BATCH, encoder_dtype="float32", checkpoint_dir=jax_checkpoint)
    jp = JPredictor(JConfig(**kw), smpl=tiny_model)  # restores the raw tree
    jp.hmr = JHMR(tiny_model, encoder_stage_sizes=STAGES)  # the shallow encoder of the state
    jp._predict = jax.jit(jp._predict_impl)
    tp = Predictor(Config(encoder_stage_sizes="1,1,1,1", **kw), smpl=synthetic_model(num_verts=120, seed=0),
                   device="cpu")
    images = rng.randint(0, 256, size=(BATCH + 2, IMG, IMG, 3)).astype(np.uint8)
    ref, out = jp.predict(images), tp.predict(images)
    assert set(out) == set(ref)
    for key in out:
        ref_k = np.asarray(ref[key])
        np.testing.assert_allclose(out[key], ref_k, rtol=1e-4, atol=1e-4 * float(np.abs(ref_k).max()),
                                   err_msg=key)


def test_predictor_refuses_weights_of_another_encoder(jax_checkpoint):
    cfg = _cfg(checkpoint_dir=jax_checkpoint, encoder_stage_sizes="1,1,2,1")
    with pytest.raises(RuntimeError, match=r"do not fit the configured model, \(backbone, head\) = \('resnet', 'ief'\), "
                       r"encoder stage sizes \(1, 1, 2, 1\)"):
        Predictor(cfg, smpl=synthetic_model(num_verts=120, seed=0), device="cpu")
