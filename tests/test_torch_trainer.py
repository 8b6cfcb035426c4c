"""The port's training loop (``train/trainer.py``) and command lines on the
CPU at a small size (encoder (1, 1, 1, 1), 56 px, P=256, batch 4).

Against the JAX package: from one JAX state on disk (Orbax), the two
``validate_checkpoint`` sweeps over the same numpy batches agree at rtol
1e-5 (mean KPR / MR losses, the PCK curve, AUC, per-joint PCK); over 4
steps of one configuration (validation every 2 steps, scalars every 3
with the epoch-final row, 2 steps per call) both trainers' writers log the
same (tag, step) sequence. Values are not compared there: the packages
draw their dropout masks differently.

The port's own contracts: 6 straight steps equal 3 + save + a fresh
Trainer + 3 bit for bit (a resumable image stream and NpzMocapPipeline);
the encoder graft; the profiler trace; the unknown-dataset error; the int8
validation sweep against a hand loop; the three CLIs end to end on an npz
sandbox. A ``cuda``-marked
test repeats the save / restore round trip on the card.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.core.smpl import save_model_npz
from human_pose_estimation_tpu.data.npz_dataset import NpzMocapPipeline as JNpzMocapPipeline
from human_pose_estimation_tpu.train.step import GenBatch as JGenBatch
from human_pose_estimation_tpu.train.trainer import Trainer as JTrainer
from human_pose_estimation_tpu.utils import checkpoint as jckpt
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.data.npz_dataset import (
    NpzMocapPipeline,
    write_mocap_npz_shard,
    write_npz_shard,
)
from human_pose_estimation_tpu_torch.train.step import GenBatch
from human_pose_estimation_tpu_torch.train.trainer import Trainer
from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

IMG = 56
BATCH = 4
NSIL = 256
STAGES = (1, 1, 1, 1)


def _arrays(rng):
    """One batch as numpy: images, prefix silhouettes (one empty), kp2d."""
    images = (rng.rand(BATCH, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    counts = rng.randint(20, NSIL + 1, size=BATCH)
    counts[2] = 0
    seg_mask = (np.arange(NSIL)[None] < counts[:, None]).astype(np.float32)
    seg_points = rng.randint(0, IMG, size=(BATCH, NSIL, 2)).astype(np.float32) * seg_mask[..., None]
    kp2d = (rng.rand(BATCH, 19, 3) * 2 - 1).astype(np.float32)
    kp2d[..., 2] = (rng.rand(BATCH, 19) > 0.2).astype(np.float32)
    return images, seg_points, seg_mask, kp2d


def _port_batch(arrays):
    return GenBatch(*map(torch.from_numpy, arrays))


def _jax_batch(arrays):
    return JGenBatch(*map(jnp.asarray, arrays))


class ImageStream:
    """Seeded batches by position, resumable: the batch at position i
    depends on (seed, i) alone, and ``{"pos": i}`` is the stream's state."""

    def __init__(self, seed=0, to=_port_batch):
        self.seed, self.pos, self.to = seed, 0, to

    def get_state(self):
        return {"pos": self.pos}

    def set_state(self, state):
        self.pos = int(state["pos"])

    def __iter__(self):
        while True:
            arrays = _arrays(np.random.RandomState(self.seed * 100003 + self.pos))
            self.pos += 1
            yield self.to(arrays), BATCH


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, tiny_model):
    tmp = tmp_path_factory.mktemp("torch_trainer")
    rng = np.random.RandomState(11)
    write_mocap_npz_shard(str(tmp / "mocap.npz"), rng.randn(48, 72) * 0.2, rng.randn(48, 10) * 0.03)
    save_model_npz(tiny_model, str(tmp / "model.npz"))
    return tmp


def _kw(workdir, **kw):
    base = dict(
        smpl_model_path=str(workdir / "model.npz"), checkpoint_dir=str(workdir / "ckpt"), model_dir=None,
        datasets=["lsp_16"], val_datasets=["lsp_16"], mocap_datasets=["CMU"], batch_size=BATCH, img_size=IMG,
        epoch=1000, max_silhouette_points=NSIL, use_mesh_repro_loss=True, encoder_dtype="float32",
        validation_step_size=2, log_img_step=0, checkpoint_every_epochs=1, num_examples_override=12,
        encoder_stage_sizes="1,1,1,1",
    )
    base.update(kw)
    return base


def _trainer(workdir, dataset=None, mocap=True, **kw):
    cfg = Config(**_kw(workdir, **kw))
    smpl = synthetic_model(num_verts=120, seed=0)
    mocap_ds = (
        NpzMocapPipeline(cfg, smpl, [str(workdir / "mocap.npz")], seed=9, device="cpu") if mocap else None
    )
    return Trainer(cfg, dataset=dataset, mocap_dataset=mocap_ds, smpl=smpl, device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package


def test_validate_checkpoint_matches_jax(workdir, tiny_model, tmp_path):
    """The JAX trainer's own state, saved by the JAX package, is what both
    sweeps restore (the port's fresh init differs from it)."""
    d = str(tmp_path / "jax_ck")
    rng = np.random.RandomState(5)
    batches = [(_arrays(rng), n) for n in (BATCH, BATCH, 3)]  # the last one partial
    kw = _kw(workdir, checkpoint_dir=d)
    jt = JTrainer(JConfig(**kw), val_dataset=[(_jax_batch(a), n) for a, n in batches], validation_only=True,
                  smpl=tiny_model, use_mesh=False)
    jckpt.save_train_state(d, jt.state, step=5)
    ref = jt.validate_checkpoint(restore=True)
    tt = Trainer(Config(**kw), val_dataset=[(_port_batch(a), n) for a, n in batches], validation_only=True,
                 smpl=synthetic_model(num_verts=120, seed=0), device="cpu")
    out = tt.validate_checkpoint(restore=True)
    assert ckpt.latest_step(d) == 5  # the step of the directory; the state's own step is 0
    assert set(out) == set(ref)
    for key in out:
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5, atol=1e-7, err_msg=key)


def test_logged_tag_step_sequence_matches_jax(workdir, tiny_model):
    """2 steps per epoch, scalars every 3 steps (so steps 2, 3 and 4 log:
    two epoch ends and the cadence), validation every 2 steps, 2 steps per
    call, 4 steps."""
    kw = _kw(workdir, steps_per_call=2, scalar_log_step=3, validation_step_size=2, num_examples_override=8,
             checkpoint_every_epochs=1000)
    jcfg = JConfig(**kw)
    jt = JTrainer(jcfg, dataset=ImageStream(1, _jax_batch), val_dataset=ImageStream(2, _jax_batch),
                  smpl=tiny_model, use_mesh=False)
    jt.mocap_dataset = JNpzMocapPipeline(jcfg, tiny_model, [str(workdir / "mocap.npz")], seed=9)
    jt.train(max_steps=4)
    tt = _trainer(workdir, dataset=ImageStream(1), **kw)
    tt.val_dataset = ImageStream(2)
    tt.train(max_steps=4)
    for name in ("train", "val"):
        got = [(tag, step) for tag, step, _ in tt.writers[name].history]
        want = [(tag, step) for tag, step, _ in jt.writers[name].history]
        assert got == want, name
    steps = sorted({s for _, s, _ in tt.writers["train"].history})
    assert steps == [2, 3, 4] and tt.state.step == 4
    assert sorted({s for _, s, _ in tt.writers["val"].history}) == [2, 4]


# ---------------------------------------------------------------------------
# the port's own contracts


def test_resume_is_bit_equal_to_straight_run(workdir, tmp_path):
    """6 straight steps == 3 steps, save (weights, both input streams), a
    fresh Trainer, restore, 3 more: every tensor of the state bit-equal,
    the logged scalars of steps 4-6 equal; the mocap stream crosses its
    epoch (48 samples, 12 per step)."""
    kw = dict(use_validation=False, checkpoint_every_epochs=1000)
    straight = _trainer(workdir, ImageStream(3), checkpoint_dir=str(tmp_path / "a"), **kw)
    straight.train(max_steps=6)

    first = _trainer(workdir, ImageStream(3), checkpoint_dir=str(tmp_path / "b"), **kw)
    first.train(max_steps=3)
    first.save()
    assert ckpt.restore_input_state(str(tmp_path / "b")) == {"image": {"pos": 3}, "mocap": {"epoch": 0, "pos": 36}}
    resumed = _trainer(workdir, ImageStream(3), checkpoint_dir=str(tmp_path / "b"), train_from_checkpoint=True, **kw)
    resumed.train(max_steps=6)

    assert straight.state.step == resumed.state.step == 6
    assert resumed.mocap_dataset.get_state() == straight.mocap_dataset.get_state()
    a, b = straight.state.state_dict(), resumed.state.state_dict()

    def walk(x, y, path=""):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path

    walk(a, b)
    tail = lambda t: [r for r in t.writers["train"].history if r[1] > 3 and not r[0].startswith("perf/")]
    assert tail(straight) == tail(resumed) and len(tail(straight)) > 0


def test_init_encoder_from_grafts_encoder(workdir, tmp_path):
    kw = dict(use_validation=False, use_mesh_repro_loss=False, encoder_only=True, do_bone_evaluation=False)
    donor = _trainer(workdir, ImageStream(4), mocap=False, checkpoint_dir=str(tmp_path / "donor"), **kw)
    donor.train(max_steps=2)
    donor.save()
    grafted = _trainer(workdir, mocap=False, checkpoint_dir=str(tmp_path / "fresh"),
                       init_encoder_from=str(tmp_path / "donor"), **kw)
    clean = _trainer(workdir, mocap=False, checkpoint_dir=str(tmp_path / "clean"), **kw)
    assert grafted.state.step == 0
    g, d, c = (t.state.hmr.state_dict() for t in (grafted, donor, clean))
    for k in g:
        if k.startswith("encoder."):
            assert torch.equal(g[k], d[k]), k
        else:
            assert torch.equal(g[k], c[k]), k
    assert any(not torch.equal(g[k], d[k]) for k in g if k.startswith("regressor."))
    with pytest.raises(ValueError, match="does not match"):
        cfg = Config(**_kw(workdir, checkpoint_dir=str(tmp_path / "bad"), init_encoder_from=str(tmp_path / "donor"),
                           encoder_stage_sizes="1,1,2,1", **kw))
        Trainer(cfg, smpl=synthetic_model(num_verts=120, seed=0), device="cpu")


def test_profiler_trace_capture(workdir, tmp_path):
    prof = str(tmp_path / "trace")
    t = _trainer(workdir, ImageStream(5), profile_dir=prof, profile_start_step=1, profile_end_step=2,
                 checkpoint_dir=str(tmp_path / "ck"), use_validation=False)
    t.train(max_steps=3)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert traces, f"no trace files under {prof}"
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_unknown_dataset_size_raises_not_silent(workdir):
    smpl = synthetic_model(num_verts=120, seed=0)
    with pytest.raises(ValueError, match="num_examples_override"):
        Trainer(Config(**_kw(workdir, datasets=["my_custom_set"], num_examples_override=0)), smpl=smpl,
                validation_only=True, device="cpu")
    t = Trainer(Config(**_kw(workdir, datasets=["my_custom_set"], num_examples_override=32)), smpl=smpl,
                validation_only=True, device="cpu")
    assert t.num_itr_per_epoch == 8  # 32 / batch 4


def test_validate_checkpoint_refuses_int8(workdir, tmp_path):
    """validate_checkpoint with encoder_int8 (no longer refused) sweeps the
    int8 serving graph: the encoder quantized once and calibrated on the
    first validation batch; the results equal a hand loop of make_val_step
    with those int8 weights (rtol 1e-6) and differ from the float sweep."""
    from human_pose_estimation_tpu_torch.train.step import make_val_step

    rng = np.random.RandomState(6)
    batches = [(_port_batch(_arrays(rng)), n) for n in (BATCH, 3)]
    t = Trainer(Config(**_kw(workdir, encoder_int8=True, checkpoint_dir=str(tmp_path / "none"))),
                val_dataset=batches, validation_only=True, smpl=synthetic_model(num_verts=120, seed=0),
                device="cpu")
    results = t.validate_checkpoint()
    qp = t.state.hmr.quantize_encoder(calibration_images=batches[0][0].images)
    step = make_val_step(t.state.hmr, t.state.critic, t.config)
    outs = [step(t.state.mean_theta, b, qp) for b, _ in batches]
    np.testing.assert_allclose(results["mean_kpr_loss"], np.mean([float(o["kpr_losses"][-1]) for o in outs]),
                               rtol=1e-6)
    np.testing.assert_allclose(results["mean_mr_loss"], np.mean([float(o["mr_losses"][-1]) for o in outs]),
                               rtol=1e-6)
    t.config = t.config.replace(encoder_int8=False)
    assert t.validate_checkpoint(restore=False)["mean_kpr_loss"] != results["mean_kpr_loss"]


# ---------------------------------------------------------------------------
# the command lines, end to end on the CPU


@pytest.fixture(scope="module")
def sandbox(tmp_path_factory, tiny_model):
    """The lsp_16 npz sandbox: 16 JPEG/PNG examples, a mocap shard, the
    body model and 3 loose JPEGs for predict."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("sandbox")
    data = root / "datasets"
    (data / "mocap_neutrMosh").mkdir(parents=True)
    rng = np.random.RandomState(13)
    jpegs, pngs, labels, centers = [], [], [], []
    for _ in range(16):
        h, w = 80, 72
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        seg = np.zeros((h, w), np.uint8)
        seg[20:60, 18:50] = 255
        jpegs.append(cv2.imencode(".jpg", img)[1].tobytes())
        pngs.append(cv2.imencode(".png", seg)[1].tobytes())
        lab = np.zeros((3, 14), np.float32)
        lab[0], lab[1], lab[2] = rng.rand(14) * (w - 1), rng.rand(14) * (h - 1), 1.0
        labels.append(lab)
        centers.append([w // 2, h // 2])
    write_npz_shard(str(data / "lsp_16.npz"), jpegs, pngs, np.stack(labels), np.asarray(centers, np.int32))
    write_mocap_npz_shard(str(data / "mocap_neutrMosh" / "neutrSMPL_CMU_0.npz"),
                          rng.randn(64, 72) * 0.2, rng.randn(64, 10) * 0.03)
    (root / "models").mkdir()
    save_model_npz(tiny_model, str(root / "models" / "model.npz"))
    (root / "photos").mkdir()
    for i in range(3):
        cv2.imwrite(str(root / "photos" / f"p{i}.jpg"), (rng.rand(90, 70, 3) * 255).astype(np.uint8))
    return root


def test_cli_train_validate_predict(sandbox, tmp_path, capsys):
    from human_pose_estimation_tpu_torch.cli import predict as cli_predict
    from human_pose_estimation_tpu_torch.cli import train as cli_train
    from human_pose_estimation_tpu_torch.cli import validate_checkpoint as cli_val

    logs, ckdir = str(tmp_path / "logs"), str(tmp_path / "ckpt")
    common = [
        "--input_pipeline", "npz", "--data_dir", str(sandbox / "datasets"),
        "--smpl_model_path", str(sandbox / "models" / "model.npz"), "--val_datasets", "lsp_16",
        "--batch_size", "4", "--img_size", str(IMG), "--max_silhouette_points", str(NSIL),
        "--encoder_dtype", "float32", "--encoder_stage_sizes", "1,1,1,1", "--checkpoint_dir", ckdir,
    ]
    cli_train.main(common + [
        "--logs", logs, "--datasets", "lsp_16", "--mocap_datasets", "CMU", "--epoch", "1",
        "--use_mesh_repro_loss", "true", "--checkpoint_every_epochs", "1", "--validation_step_size", "2",
        "--log_img_step", "0",
    ], device="cpu")
    runs = os.listdir(logs)
    assert len(runs) == 1 and runs[0].startswith("HMR__1e_")
    assert json.load(open(os.path.join(logs, runs[0], "params.json")))["datasets"] == ["lsp_16"]
    assert ckpt.latest_step(ckdir) == 4  # 16 images / batch 4, one epoch
    assert os.path.isfile(os.path.join(ckdir, "4", ckpt.PAYLOAD))

    capsys.readouterr()
    results = cli_val.main(common + ["--logs", str(tmp_path / "vlogs")], device="cpu")
    out = capsys.readouterr().out
    assert "PCK@0.5" in out and str(results) in out
    assert np.isfinite(results["mean_kpr_loss"]) and np.isfinite(results["mean_mr_loss"])
    assert 0.0 <= results["pck@0.5"] <= 1.0 and len(results["per_joint_pck@0.5"]) == 14

    out_dir = tmp_path / "preds"
    cli_predict.main(common + ["--inputs", str(sandbox / "photos"), "--out_dir", str(out_dir), "--render"],
                     device="cpu")
    for i in range(3):
        z = np.load(out_dir / f"p{i}.npz")
        assert z["verts"].shape == (120, 3) and np.isfinite(z["verts"]).all()
        assert z["theta"].shape == (85,)
        assert os.path.isfile(out_dir / f"p{i}_overlay.png")


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_trainer_save_restore_on_card(tmp_path):
    """Two Trainer steps on the card, a save, and a restore into a fresh
    Trainer that is bit-equal. Needs no fixture of the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(11)
    write_mocap_npz_shard(str(tmp_path / "mocap.npz"), rng.randn(48, 72) * 0.2, rng.randn(48, 10) * 0.03)

    def make(**kw):
        cfg = Config(**_kw(tmp_path, checkpoint_dir=str(tmp_path / "ck"), use_validation=False, **kw))
        smpl = synthetic_model(num_verts=120, seed=0)
        mocap = NpzMocapPipeline(cfg, smpl, [str(tmp_path / "mocap.npz")], seed=9, device="cuda")
        to = lambda a: GenBatch(*(torch.from_numpy(x).cuda() for x in a))
        return Trainer(cfg, dataset=ImageStream(7, to), mocap_dataset=mocap, smpl=smpl, device="cuda")

    t = make()
    t.train(max_steps=2)
    t.save()
    fresh = make()
    assert fresh.restore() == 2
    a, b = t.state.state_dict(), fresh.state.state_dict()
    for group in ("hmr", "critic"):
        for k in a[group]:
            assert torch.equal(a[group][k], b[group][k]), k
    for group in ("gen_adam", "critic_adam"):
        assert a[group]["step"] == b[group]["step"] == 2
        for moment in ("exp_avg", "exp_avg_sq"):
            for k in a[group][moment]:
                assert torch.equal(a[group][moment][k], b[group][moment][k]), k
    assert torch.equal(a["mean_theta"], b["mean_theta"]) and fresh.state.step == 2
    assert fresh.mocap_dataset.get_state() == t.mocap_dataset.get_state()

    # a Predictor on the card restores the same weights, and starts from the
    # seed's init (drawn on the CPU, as HMR draws it) without a checkpoint
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor
    from human_pose_estimation_tpu_torch.models.hmr import HMR

    smpl = synthetic_model(num_verts=120, seed=0)
    for ck, want in ((tmp_path / "ck", a["hmr"]),
                     (tmp_path / "none", HMR(smpl, encoder_stage_sizes=STAGES, device="cpu", seed=3).state_dict())):
        serve = Config(img_size=IMG, batch_size=BATCH, encoder_stage_sizes="1,1,1,1", checkpoint_dir=str(ck), seed=3)
        got = Predictor(serve, smpl=smpl, device="cuda").hmr.state_dict()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k].cpu()), k
