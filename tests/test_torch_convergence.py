"""Closed-loop training quality of the port, on the CPU (the port of
``tests/test_convergence.py::test_kp_only_overfit_smoke``).

Ground truth is generated from the synthetic rigged human
(``utils/synthetic_human.py``, 900 vertices, ring 8) by the port's
``data/synthetic.py``: sample (theta, beta, cam) -> render RGB and
silhouette -> project keypoints -> tfrecords. The port's ``Trainer``
then trains on them through the port's tf.data ``ImagePipeline``, and
the JAX test's own assertions must hold: the recipe measurably learns
pose from the rendered images within 300 steps. The JAX test's
env-gated full-recipe variant is not ported; ``chip_smoke.py``'s
``[closed-loop]`` runs the full recipe on the card, and its code is
rehearsed here at a tiny size.
"""
import os
import sys

import numpy as np
import pytest
import torch

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.core.smpl import save_model_npz
from human_pose_estimation_tpu_torch.data.synthetic import generate_closed_loop_dataset
from human_pose_estimation_tpu_torch.train.trainer import Trainer
from human_pose_estimation_tpu_torch.utils.synthetic_human import synthetic_human_model

IMG = 64
N_TRAIN = 48
N_VAL = 16


@pytest.fixture(scope="module")
def closed_loop_dir(tmp_path_factory):
    """The JAX test's dataset (seed 0), written by the port: 48 train and
    16 val renders at 64 px, a 512-sample mocap prior, tfrecords."""
    pytest.importorskip("tensorflow")
    pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("closed_loop")
    model = synthetic_human_model(num_verts=900, ring_size=8)
    stats = generate_closed_loop_dataset(
        str(tmp),
        model,
        n_train=N_TRAIN,
        n_val=N_VAL,
        n_mocap=512,
        img_size=IMG,
        seed=0,
        fmt="tfrecord",
        train_name="synth_train",
        val_name="synth_val",
        device="cpu",
    )
    save_model_npz(model, str(tmp / "model.npz"))
    return str(tmp), stats


def test_kp_only_overfit_smoke(closed_loop_dir):
    """Keypoint-only supervised training on the rendered set (the JAX
    test's Config, the (1, 1, 1, 1) encoder, f32, batch 8, lr 3e-4) must
    halve the training keypoint loss within 300 steps (the mean of the
    last 10 logged values below half the mean of the first 10), and the
    validation PCK@0.5 must rise by more than 0.05 over the second 150
    steps and end at 0.35 or more: the JAX test's thresholds. The
    validation PCK is not monotone early (the BN moving averages start at
    an accidental optimum and dip mid-run), hence the second-half rise and
    the floor rather than a comparison with step 0."""
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline

    out_dir, stats = closed_loop_dir
    assert stats["n_train"] == N_TRAIN and stats["sil_pixels_p50"] > 100
    cfg = Config(
        smpl_model_path=os.path.join(out_dir, "model.npz"),
        data_dir=out_dir,
        logs=os.path.join(out_dir, "logs"),
        model_dir=os.path.join(out_dir, "logs", "smoke"),
        checkpoint_dir=os.path.join(out_dir, "ckpt_smoke"),
        datasets=["synth_train"],
        val_datasets=["synth_val"],
        num_examples_override=N_TRAIN,
        img_size=IMG,
        batch_size=8,
        epoch=1000,  # bounded by max_steps below
        generator_lr=3e-4,
        use_kpr_loss=True,
        use_mesh_repro_loss=False,  # kp-only: no chamfer, no critic
        encoder_only=True,
        do_bone_evaluation=False,
        max_silhouette_points=256,
        encoder_dtype="float32",
        encoder_stage_sizes="1,1,1,1",
        use_validation=False,
        log_img_step=0,
        checkpoint_every_epochs=10**6,
        scalar_log_step=10,
    )
    files = [os.path.join(out_dir, "synth_train.tfrecords")]
    val_files = [os.path.join(out_dir, "synth_val.tfrecords")]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite's workers share the host's cores
    try:
        trainer = Trainer(
            cfg,
            dataset=ImagePipeline(cfg, files=files, mode="train", canvas=IMG, device="cpu"),
            val_dataset=ImagePipeline(cfg, files=val_files, mode="val", augment=False, canvas=IMG, device="cpu"),
            device="cpu",
        )
        pck0 = trainer.validate_checkpoint(restore=False)["pck@0.5"]
        h1 = trainer.train(max_steps=150)
        pck_mid = trainer.validate_checkpoint(restore=False)["pck@0.5"]
        h2 = trainer.train(max_steps=150)  # 150 more -> global step 300
        pck1 = trainer.validate_checkpoint(restore=False)["pck@0.5"]
    finally:
        torch.set_num_threads(threads)

    kpr = np.asarray(h1["kpr"] + h2["kpr"])
    head, tail = kpr[:10].mean(), kpr[-10:].mean()
    print(f"smoke: train kpr {head:.2f} -> {tail:.2f}, PCK {pck0:.3f} -> {pck_mid:.3f} -> {pck1:.3f}")
    assert trainer.state.step == 300
    assert np.isfinite(kpr).all()
    assert tail < 0.5 * head, (head, tail)
    assert pck1 > pck_mid + 0.05, (pck_mid, pck1)
    assert pck1 >= 0.35, (pck0, pck_mid, pck1)


def test_chip_smoke_closed_loop_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """``chip_smoke.closed_loop``, the ``[closed-loop]`` phase's code, at a
    tiny size on the CPU (16 + 8 renders at 64 px, the (1, 1, 1, 1)
    encoder, batch 4, 16 steps, the chamfer's plain versions): both
    evaluation rows carry every metric of the quality bench's schema,
    finite; the loop takes and logs every step; the phase's own checks
    pass (it raises otherwise)."""
    pytest.importorskip("cv2")  # the shard writers are not needed; the renderer is
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    import chip_smoke

    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    monkeypatch.setattr(chip_smoke, "SMOKE_DIR", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = chip_smoke.closed_loop(
            torch, cc, device="cpu", n_train=16, n_val=8, n_mocap=64, render=64, img=64, batch=4, steps=16,
            sil=512, encoder_stage_sizes="1,1,1,1", warm=2, sync_steps=2, window=4,
        )
    finally:
        torch.set_num_threads(threads)
    assert [row["step"] for row in r["rows"]] == [0, 16]
    keys = {"config", "seed", "step", "rss_gb", "kpr", "mr", "pck@0.5", "pck_auc", "vert_err", "pa_vert_err",
            "cam_scale_ratio"}
    for row in r["rows"]:
        assert set(row) == keys
        assert all(np.isfinite(v) for k, v in row.items() if k != "config")
    assert r["steps"] == 16 and r["kpr_tail"] < r["kpr_head"]
    assert r["sil"]["sil_pixels_max"] > 0 and r["render_ms"] > 0
    assert "chip_smoke" in sys.modules
