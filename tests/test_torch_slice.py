"""The port's forward path as a whole against the JAX package on the same
bridged state, in f32 on the CPU at a small size: ``make_val_step`` (the
evaluation step: HMR with the body model on every stage, keypoint,
mesh-reprojection and critic losses) and ``Predictor`` (serving). Every
output key is compared at 1e-4 relative to its largest magnitude, except
``mr_losses`` at 2e-4: on the CPU the JAX step computes the chamfer with
the expanded-form distances of ``chamfer_loss``, which round differently
from the direct form of the port's plain version.

Also: the port imports nothing of JAX or of the JAX package, its entry
points refuse to run on the CPU unless asked, and chip_smoke.py fails
without a card."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.infer.predictor import Predictor as JPredictor
from human_pose_estimation_tpu.models.critic import Critic as JCritic
from human_pose_estimation_tpu.models.hmr import HMR as JHMR
from human_pose_estimation_tpu.ops import metrics as jmetrics
from human_pose_estimation_tpu.train.state import create_train_state
from human_pose_estimation_tpu.train.step import GenBatch as JGenBatch
from human_pose_estimation_tpu.train.step import make_val_step as jmake_val_step
from human_pose_estimation_tpu.utils.assets import synthetic_mean_params
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models import port_jax
from human_pose_estimation_tpu_torch.models.critic import Critic
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.ops import metrics as tmetrics
from human_pose_estimation_tpu_torch.parallel import mesh as pmesh
from human_pose_estimation_tpu_torch.train.state import create_train_state as tcreate_train_state
from human_pose_estimation_tpu_torch.train.step import GenBatch, make_train_step, make_val_step
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
BATCH = 4
NSIL = 256
STAGES = (1, 1, 1, 1)


def assert_rel(out, ref, rtol, name=""):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()), err_msg=name)


@pytest.fixture(scope="module")
def bridged(tiny_model):
    """One JAX train state and the port's modules loaded from it."""
    jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=STAGES)
    jcritic = JCritic()
    state = create_train_state(
        jax.random.PRNGKey(0), jhmr, jcritic, synthetic_mean_params()[None, :], 1e-4, 5e-4, img_size=IMG
    )
    gen_np = jax.tree.map(np.asarray, state.gen_params)
    variables = {
        "params": {k: gen_np[k] for k in ("encoder", "regressor")},
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats),
    }
    hmr_sd = port_jax.hmr_state_dict(variables)
    thmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu")
    thmr.load_state_dict(hmr_sd)
    critic = Critic()
    critic.load_state_dict(port_jax.flax_to_state_dict(jax.tree.map(np.asarray, state.critic_params)))
    return jhmr, jcritic, state, thmr, critic, hmr_sd, port_jax.mean_theta(gen_np["mean_theta"])


def _batch(rng):
    images = (rng.rand(BATCH, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    counts = [200, 37, 0, 256]  # prefix silhouettes, one empty
    seg_points = rng.randint(0, IMG, size=(BATCH, NSIL, 2)).astype(np.float32)
    seg_mask = np.zeros((BATCH, NSIL), np.float32)
    for b, c in enumerate(counts):
        seg_mask[b, :c] = 1.0
    kp2d = (rng.rand(BATCH, 19, 3) * 2 - 1).astype(np.float32)
    kp2d[..., 2] = (rng.rand(BATCH, 19) > 0.2).astype(np.float32)
    return images, seg_points, seg_mask, kp2d


@pytest.mark.parametrize(
    "mr_metric_stages,mr_scale_mode,encoder_only",
    [("all", "reference", False), ("last", "count", True)],
)
def test_val_step_matches_jax(bridged, rng, mr_metric_stages, mr_scale_mode, encoder_only):
    jhmr, jcritic, state, thmr, critic, _, mean = bridged
    kw = dict(
        img_size=IMG, batch_size=BATCH, use_mesh_repro_loss=True, encoder_dtype="float32",
        mr_metric_stages=mr_metric_stages, mr_scale_mode=mr_scale_mode, encoder_only=encoder_only,
    )
    arrays = _batch(rng)
    ref = jax.jit(jmake_val_step(jhmr, jcritic, JConfig(**kw), return_stages=True))(
        state, JGenBatch(*map(jnp.asarray, arrays))
    )
    out = make_val_step(thmr, critic, Config(**kw), return_stages=True)(
        mean, GenBatch(*map(torch.from_numpy, arrays))
    )
    assert set(out) == set(ref)
    for key in out:
        assert_rel(out[key], ref[key], 2e-4 if key == "mr_losses" else 1e-4, name=key)
    mr = out["mr_losses"].numpy()
    assert (mr[:-1] > 0).all() if mr_metric_stages == "all" else (mr[:-1] == 0).all()
    # the validation sweep's metrics on the step's keypoints
    kp_gt = torch.from_numpy(arrays[3][:, :14])
    kp_pred = out["pred_keypoints"]
    jgt, jpred = jnp.asarray(arrays[3][:, :14]), jnp.asarray(ref["pred_keypoints"])
    assert_rel(tmetrics.pck(kp_gt, kp_pred), jmetrics.pck(jgt, jpred), 1e-6, "pck")
    assert_rel(tmetrics.pck_curve(kp_gt, kp_pred), jmetrics.pck_curve(jgt, jpred), 1e-6, "pck_curve")
    assert_rel(tmetrics.pck_auc(kp_gt, kp_pred), jmetrics.pck_auc(jgt, jpred), 1e-5, "pck_auc")
    assert_rel(tmetrics.per_joint_pck(kp_gt, kp_pred), jmetrics.per_joint_pck(jgt, jpred), 1e-6, "per_joint")


def test_predictor_matches_jax(bridged, tiny_model, rng):
    """uint8 requests: a partial batch (padding), and one larger than the
    batch (cut into batches); the outputs filter; predict_single_image."""
    jhmr, _, state, _, _, hmr_sd, mean = bridged
    cfg = dict(img_size=IMG, batch_size=BATCH, encoder_dtype="float32")
    variables = {
        "params": {k: state.gen_params[k] for k in ("encoder", "regressor")},
        "batch_stats": state.batch_stats,
    }
    jp = JPredictor(JConfig(**cfg), smpl=tiny_model, variables=variables,
                    mean_theta=state.gen_params["mean_theta"])
    jp.hmr = JHMR(tiny_model, encoder_stage_sizes=STAGES)  # the shallow encoder of the state
    jp._predict = jax.jit(jp._predict_impl)
    tp = Predictor(Config(encoder_stage_sizes="1,1,1,1", **cfg), smpl=synthetic_model(num_verts=120, seed=0),
                   variables=hmr_sd, mean_theta=mean, device="cpu")
    for n in (3, 6):
        images = rng.randint(0, 256, size=(n, IMG, IMG, 3)).astype(np.uint8)
        ref = jp.predict(images)
        out = tp.predict(images)
        assert set(out) == set(ref) == {"generated_verts", "generated_cams", "generated_joints", "theta", "kp2d"}
        for key in out:
            assert out[key].shape[0] == n
            assert_rel(out[key], ref[key], 1e-4, name=f"{key} n={n}")
    verts, cams, joints = tp.predict_single_image(images[0])
    assert_rel(verts, ref["generated_verts"][:1], 1e-4, "single verts")
    assert cams.shape == (1, 3) and joints.shape == (1, 14, 3)
    tp.outputs = ("generated_joints",)
    assert set(tp.predict(images[:2])) == {"generated_joints"}


def test_predictor_refuses_unported_options(bridged, tmp_path, monkeypatch):
    """Data-parallel serving is ported: over two CPU device entries it
    serves what the plain predictor serves (atol 1e-5); the int8 encoder
    leaves its activation scales to the first real batch. Without
    variables the Predictor restores from ``checkpoint_dir`` (fresh from
    ``seed`` when it holds no checkpoint)."""
    _, _, _, _, _, hmr_sd, mean = bridged
    cfg = Config(img_size=IMG, batch_size=BATCH, encoder_dtype="float32", encoder_stage_sizes="1,1,1,1",
                 checkpoint_dir=str(tmp_path / "empty"), seed=3)
    smpl = synthetic_model(num_verts=30)
    restored = Predictor(cfg, smpl=smpl, device="cpu")
    seeded = HMR(smpl, encoder_stage_sizes=STAGES, device="cpu", seed=3).state_dict()
    assert all(torch.equal(v, seeded[k]) for k, v in restored.hmr.state_dict().items())
    real_mesh = pmesh.make_mesh
    two = lambda devices=None, batch_size=None: real_mesh(["cpu"] * 2, batch_size)  # noqa: E731
    monkeypatch.setattr(pmesh, "make_mesh", two)  # two local device entries, simulated on the CPU
    dp = Predictor(cfg, smpl=smpl, variables=hmr_sd, mean_theta=mean, device="cpu", data_parallel=True)
    plain = Predictor(cfg, smpl=smpl, variables=hmr_sd, mean_theta=mean, device="cpu")
    images = np.random.RandomState(6).randint(0, 256, (3, IMG, IMG, 3)).astype(np.uint8)
    got, ref = dp.predict(images), plain.predict(images)
    assert len(dp.replicas) == 2 and set(got) == set(ref)
    for key, v in ref.items():
        np.testing.assert_allclose(got[key], v, rtol=0, atol=1e-5, err_msg=key)
    int8 = Predictor(cfg, smpl=smpl, variables=hmr_sd, mean_theta=mean, device="cpu", encoder_int8=True)
    assert set(int8.encoder_qparams) == {"weights", "act"} and int8.encoder_qparams["act"] is None


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from human_pose_estimation_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        HMR(synthetic_model(num_verts=30), encoder_stage_sizes=STAGES)
    cfg = Config(encoder_stage_sizes="1,1,1,1", encoder_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcreate_train_state(synthetic_model(num_verts=30), np.zeros(85, np.float32), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    assert resolve_device("cpu") == torch.device("cpu")
    assert tcreate_train_state(synthetic_model(num_verts=30), np.zeros(85, np.float32), cfg, device="cpu").device.type == "cpu"
    make_train_step(cfg, device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port (the training state, step and
    loop, the checkpoints and the Orbax importer, the command lines, the
    renderer, the CUDA kernels' wrappers, the data modules, the int8
    encoder and the serving stack, the native libraries' loader, the native
    and tf.data pipelines, the closed-loop synthetic data, data parallelism
    and the grain pipeline among them)
    loads no jax, flax, optax, orbax, grain or JAX package module, and none of the
    optional host libraries that are imported only where they are used
    (OpenCV, tensorboardX, tensorstore, TensorFlow: the card's machine has
    none of them); chip_smoke.py imports none of them either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import human_pose_estimation_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'grain', 'human_pose_estimation_tpu', 'cv2', 'tensorboardX', "
        "'tensorstore', 'tensorflow'))\n"
        "mods = [m for m in sys.modules if m.startswith('human_pose_estimation_tpu_torch')]\n"
        "missing = {'human_pose_estimation_tpu_torch.train.state', 'human_pose_estimation_tpu_torch.train.step', "
        "'human_pose_estimation_tpu_torch.ops.cuda_chamfer', 'human_pose_estimation_tpu_torch.ops.losses', "
        "'human_pose_estimation_tpu_torch.data.augment', 'human_pose_estimation_tpu_torch.data.pipeline', "
        "'human_pose_estimation_tpu_torch.data.npz_dataset', 'human_pose_estimation_tpu_torch.data.tfrecords', "
        "'human_pose_estimation_tpu_torch.train.trainer', 'human_pose_estimation_tpu_torch.utils.checkpoint', "
        "'human_pose_estimation_tpu_torch.utils.orbax_import', 'human_pose_estimation_tpu_torch.utils.summary', "
        "'human_pose_estimation_tpu_torch.utils.image', 'human_pose_estimation_tpu_torch.viz.renderer', "
        "'human_pose_estimation_tpu_torch.cli.train', 'human_pose_estimation_tpu_torch.cli.validate_checkpoint', "
        "'human_pose_estimation_tpu_torch.cli.predict', 'human_pose_estimation_tpu_torch.models.quantize', "
        "'human_pose_estimation_tpu_torch.infer.serving', 'human_pose_estimation_tpu_torch.infer.http_server', "
        "'human_pose_estimation_tpu_torch.infer.export', 'human_pose_estimation_tpu_torch.cli.serve', "
        "'human_pose_estimation_tpu_torch.cli.export_model', 'human_pose_estimation_tpu_torch.native', "
        "'human_pose_estimation_tpu_torch.data.native_pipeline', 'human_pose_estimation_tpu_torch.data.synthetic', "
        "'human_pose_estimation_tpu_torch.utils.synthetic_human', 'human_pose_estimation_tpu_torch.cli.create_synthetic', "
        "'human_pose_estimation_tpu_torch.parallel.mesh', 'human_pose_estimation_tpu_torch.data.grain_pipeline'"
        "} - set(mods)\n"
        "print(len(mods), bad, sorted(missing))\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 55  # every module was imported

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "grain", "human_pose_estimation_tpu", "cv2", "tensorboardX",
              "tensorstore", "tensorflow"}
    assert not {n for n in names if n.split(".")[0] in banned}, names


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
