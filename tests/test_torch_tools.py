"""The port's host tools against the JAX package's, on the CPU:
``cli/create_datasets.py`` (on the fabricated LSP / LSP-ext / MPII tree
of ``tests/test_create_datasets_cli.py``), ``cli/visualize_datasets.py``,
``cli/train_many.py``, ``viz/datasets.py`` and ``cli/preview.py``.

Tolerances: converted records and shards equal JAX's field by field,
exactly (the same TensorFlow / OpenCV calls); the meshes that
``draw_smpl_meshes`` renders within 1e-5 of JAX's vertices and their
panels exactly; ``annotate_frame`` within 2/255 per pixel of JAX's on
bridged weights (f32).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
scipy_io = pytest.importorskip("scipy.io")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from human_pose_estimation_tpu.cli import create_datasets as jcreate_datasets  # noqa: E402
from human_pose_estimation_tpu.data import tfrecords as jtfrecords  # noqa: E402
from human_pose_estimation_tpu_torch.cli import create_datasets  # noqa: E402
from human_pose_estimation_tpu_torch.config import Config  # noqa: E402
from human_pose_estimation_tpu_torch.core.smpl import save_model_npz  # noqa: E402
from human_pose_estimation_tpu_torch.data import tfrecords  # noqa: E402
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model  # noqa: E402

IMG = 56
RECORDS = ("lsp_train", "lsp_val", "lsp_ext", "mpii")


def _write_image(path, h, w, rng):
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    enc = tf.io.encode_jpeg(img) if str(path).endswith(".jpg") else tf.io.encode_png(img)
    tf.io.write_file(str(path), enc)


def _write_seg(path, h, w, channels=1):
    seg = np.zeros((h, w, channels), np.uint8)
    seg[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = 255
    tf.io.write_file(str(path), tf.io.encode_png(seg))


def _raw_tree(tmp):
    """tests/test_create_datasets_cli.py's tree: LSP im0001..im0006 with
    joints.mat (3, 14, N), occlusion flags and no segmentation for im0005;
    LSP-ext im00001..im00004 with 3-channel segmentations for the even
    ones only and joints.mat (14, 3, N); MPII 2 images with 16 joints.
    Each joints.mat column is tagged with its image number."""
    rng = np.random.RandomState(0)
    h, w = 80, 72
    dirs = {k: (tmp / k / "images", tmp / "upi" / k) for k in ("lsp", "lsp_ext", "mpii")}
    for img, seg in dirs.values():
        img.mkdir(parents=True)
        seg.mkdir(parents=True)
    lsp = np.zeros((3, 14, 6), np.float32)
    for i in range(1, 7):
        _write_image(dirs["lsp"][0] / f"im{i:04d}.jpg", h, w, rng)
        if i != 5:
            _write_seg(dirs["lsp"][1] / f"im{i:04d}_segmentation.png", h, w)
        lsp[0, :, i - 1], lsp[1, :, i - 1] = np.arange(14) + 100.0 * i, np.arange(14) + 0.5
    scipy_io.savemat(str(tmp / "lsp_joints.mat"), {"joints": lsp})
    ext = np.zeros((3, 14, 4), np.float32)
    for i in range(1, 5):
        _write_image(dirs["lsp_ext"][0] / f"im{i:05d}.png", h, w, rng)
        if i % 2 == 0:
            _write_seg(dirs["lsp_ext"][1] / f"im{i:05d}_segmentation.png", h, w, channels=3)
        ext[0, :, i - 1], ext[1, :, i - 1], ext[2, :, i - 1] = np.arange(14) + 1000.0 * i, np.arange(14) + 0.25, 1.0
    scipy_io.savemat(str(tmp / "ext_joints.mat"), {"joints": ext.transpose(1, 0, 2)})
    mp = np.zeros((3, 16, 2), np.float32)
    for i in range(1, 3):
        _write_image(dirs["mpii"][0] / f"{i:05d}.png", h, w, rng)
        _write_seg(dirs["mpii"][1] / f"{i:05d}_segmentation.png", h, w)
        mp[0, :, i - 1], mp[1, :, i - 1], mp[2, :, i - 1] = np.arange(16) + 10.0 * i, np.arange(16), 1.0
    scipy_io.savemat(str(tmp / "mpii_joints.mat"), {"joints": mp})
    return [
        "--lsp_dir", str(dirs["lsp"][0]), "--lsp_seg_dir", str(dirs["lsp"][1]),
        "--lsp_joints", str(tmp / "lsp_joints.mat"),
        "--lsp_ext_dir", str(dirs["lsp_ext"][0]), "--lsp_ext_seg_dir", str(dirs["lsp_ext"][1]),
        "--lsp_ext_joints", str(tmp / "ext_joints.mat"),
        "--mpii_dir", str(dirs["mpii"][0]), "--mpii_seg_dir", str(dirs["mpii"][1]),
        "--mpii_joints", str(tmp / "mpii_joints.mat"), "--train_count", "4",
    ]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The tree converted by both CLIs, to tfrecords and to npz shards."""
    tmp = tmp_path_factory.mktemp("assets")
    args = _raw_tree(tmp)
    out = {}
    for name, cli in (("jax", jcreate_datasets), ("port", create_datasets)):
        for fmt in ("tfrecord", "npz"):
            out[name, fmt] = str(tmp / f"{name}_{fmt}")
            cli.main(args + ["--output_dir", out[name, fmt], "--format", fmt])
    return tmp, out


def _examples(path, parse=jtfrecords.parse_image_example):
    return [{k: v.numpy() for k, v in parse(raw).items()} for raw in tf.data.TFRecordDataset([path])]


def test_create_datasets_matches_jax(converted):
    """Split inversion and sparse pairing (LSP), number-indexed joints
    (LSP-ext) and the MPII remap on the port's records, which parse equal
    to JAX's field by field; the npz shards equal JAX's array by array."""
    _, out = converted
    recs = {}
    for name in RECORDS:
        path = os.path.join(out["port", "tfrecord"], f"{name}.tfrecords")
        ours, theirs = _examples(path, tfrecords.parse_image_example), _examples(
            os.path.join(out["jax", "tfrecord"], f"{name}.tfrecords"))
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
        recs[name] = ours

    names = lambda exs: [ex["filename"].decode() for ex in exs]  # noqa: E731
    assert names(recs["lsp_train"]) == [f"im{i:04d}.jpg" for i in range(1, 5)]
    assert names(recs["lsp_val"]) == ["im0006.jpg"]  # im0005 has no segmentation
    for ex, i in zip(recs["lsp_train"] + recs["lsp_val"], [1, 2, 3, 4, 6]):
        np.testing.assert_array_equal(ex["label"][0, :14], np.arange(14) + 100.0 * i)
        assert (ex["label"][2, :14] == 1.0).all()  # occluded 0 -> visible 1
    assert names(recs["lsp_ext"]) == ["im00002.png", "im00004.png"]
    for ex, i in zip(recs["lsp_ext"], [2, 4]):
        np.testing.assert_array_equal(ex["label"][0, :14], np.arange(14) + 1000.0 * i)
    assert recs["lsp_ext"][0]["seg"].shape[-1] == 1
    for ex, i in zip(recs["mpii"], [1, 2]):
        np.testing.assert_array_equal(ex["label"][0, :14], (np.arange(16) + 10.0 * i)[list(tfrecords.MPII_TO_LSP)])

    for name in RECORDS:
        a = np.load(os.path.join(out["port", "npz"], f"{name}.npz"), allow_pickle=True)
        b = np.load(os.path.join(out["jax", "npz"], f"{name}.npz"), allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if b[k].dtype == object:
                assert [bytes(x) for x in a[k]] == [bytes(x) for x in b[k]], f"{name}/{k}"
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")


def test_converted_records_train_one_step(converted, tmp_path):
    """lsp_train.tfrecords -> the port's ImagePipeline -> one Trainer step
    (encoder (1, 1, 1, 1), 56 px)."""
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    _, out = converted
    model_path = str(tmp_path / "model.npz")
    save_model_npz(synthetic_model(num_verts=120, seed=0), model_path)
    cfg = Config(
        smpl_model_path=model_path, data_dir=out["port", "tfrecord"], logs=str(tmp_path / "logs"),
        model_dir=str(tmp_path / "logs" / "run"), checkpoint_dir=str(tmp_path / "ckpt"), datasets=["lsp_train"],
        num_examples_override=4, batch_size=4, img_size=IMG, epoch=1, max_silhouette_points=256,
        use_mesh_repro_loss=True, use_kpr_loss=True, encoder_only=True, encoder_stage_sizes="1,1,1,1",
        encoder_dtype="float32", use_validation=False, log_img_step=0, checkpoint_every_epochs=10**9,
    )
    files = [os.path.join(out["port", "tfrecord"], "lsp_train.tfrecords")]
    trainer = Trainer(cfg, dataset=ImagePipeline(cfg, files=files, mode="train", canvas=96, device="cpu"),
                      device="cpu")
    history = trainer.train(max_steps=1)
    assert trainer.state.step == 1 and np.isfinite(history["kpr"]).all()


def test_visualize_datasets_cli(converted, tmp_path, capsys):
    """Headless: one image batch of the converted records and the mocap
    meshes to PNGs."""
    from human_pose_estimation_tpu_torch.cli import visualize_datasets

    _, out = converted
    data = tmp_path / "data"
    (data / "mocap_neutrMosh").mkdir(parents=True)
    os.symlink(os.path.join(out["port", "tfrecord"], "lsp_train.tfrecords"), data / "lsp_train.tfrecords")
    rng = np.random.RandomState(2)
    tfrecords.create_mocap_tfrecord(str(data / "mocap_neutrMosh" / "neutrSMPL_CMU_0.tfrecord"),
                                    rng.randn(16, 72) * 0.2, rng.randn(16, 10) * 0.03)
    model_path = str(tmp_path / "model.npz")
    save_model_npz(synthetic_model(num_verts=120, seed=0), model_path)
    vis = str(tmp_path / "vis")
    visualize_datasets.main(
        ["--out_dir", vis, "--mocap", "--data_dir", str(data), "--datasets", "lsp_train", "--mocap_datasets", "CMU",
         "--batch_size", "2", "--img_size", str(IMG), "--max_silhouette_points", "256",
         "--smpl_model_path", model_path],
        device="cpu",
    )
    printed = capsys.readouterr().out
    for name in ("images_batch0.png", "mocap_meshes.png"):
        assert os.path.getsize(os.path.join(vis, name)) > 0
        assert f"wrote {os.path.join(vis, name)}" in printed
    assert cv2.imread(os.path.join(vis, "images_batch0.png")).shape[2] == 3


# ---------------------------------------------------------------------------
# train_many


_STAMP = re.compile(r"_[A-Z][a-z]{2}\d{2}_\d{4}$")


def _record_sweep(monkeypatch, pkg, argv, **main_kw):
    """Run ``pkg``'s train_many with its Trainer and pipelines replaced:
    the (loss flags, checkpoint_dir, run directory name without its time
    stamp) of each Trainer it builds."""
    import importlib

    trainer_mod = importlib.import_module(f"{pkg}.train.trainer")
    data_mod = importlib.import_module(f"{pkg}.data")
    seen = []

    class Recorder:
        def __init__(self, cfg, **kw):
            seen.append((cfg.use_mesh_repro_loss, cfg.use_kpr_loss, cfg.checkpoint_dir,
                         _STAMP.sub("", os.path.basename(cfg.model_dir))))

        def train(self):
            pass

        def save(self):
            pass

    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    monkeypatch.setattr(data_mod, "make_image_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(data_mod, "make_mocap_pipeline", lambda *a, **k: None)
    importlib.import_module(f"{pkg}.cli.train_many").main(argv, **main_kw)
    monkeypatch.undo()
    return seen


@pytest.fixture(scope="module")
def sandbox(tmp_path_factory):
    """An npz sandbox: lsp_16 with 4 examples, a CMU mocap shard, the body
    model."""
    from human_pose_estimation_tpu_torch.data.npz_dataset import write_mocap_npz_shard, write_npz_shard

    root = tmp_path_factory.mktemp("sweep")
    (root / "mocap_neutrMosh").mkdir()
    rng = np.random.RandomState(13)
    jpegs, pngs, labels = [], [], []
    for _ in range(4):
        seg = np.zeros((80, 72), np.uint8)
        seg[20:60, 18:50] = 255
        jpegs.append(cv2.imencode(".jpg", (rng.rand(80, 72, 3) * 255).astype(np.uint8))[1].tobytes())
        pngs.append(cv2.imencode(".png", seg)[1].tobytes())
        labels.append(np.stack([rng.rand(14) * 71, rng.rand(14) * 79, np.ones(14)]).astype(np.float32))
    write_npz_shard(str(root / "lsp_16.npz"), jpegs, pngs, np.stack(labels), np.full((4, 2), 36, np.int32))
    write_mocap_npz_shard(str(root / "mocap_neutrMosh" / "neutrSMPL_CMU_0.npz"),
                          rng.randn(64, 72) * 0.2, rng.randn(64, 10) * 0.03)
    save_model_npz(synthetic_model(num_verts=120, seed=0), str(root / "model.npz"))
    return root


def test_train_many_matches_jax_and_sweeps(sandbox, tmp_path, monkeypatch):
    """Both sweeps build their Trainers with the same loss flags, checkpoint
    directories and run-directory names; then one real port sweep of one
    step per ablation writes each ablation's checkpoint and params.json."""
    from human_pose_estimation_tpu.cli import train_many as jtrain_many
    from human_pose_estimation_tpu_torch.cli import train_many
    from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt

    assert train_many.ABLATIONS == jtrain_many.ABLATIONS
    common = ["--smpl_model_path", str(sandbox / "model.npz"), "--checkpoint_dir", str(tmp_path / "ck"),
              "--datasets", "lsp_16", "--mocap_datasets", "CMU", "--epoch", "1"]
    jseen = _record_sweep(monkeypatch, "human_pose_estimation_tpu", common + ["--logs", str(tmp_path / "jl")])
    seen = _record_sweep(monkeypatch, "human_pose_estimation_tpu_torch", common + ["--logs", str(tmp_path / "tl")],
                         device="cpu")
    assert seen == jseen and [s[3].split("_")[1:3] for s in seen] == [["mr", "only"], ["kp", "only"], ["mr", "kp"]]

    train_many.main(common + [
        "--logs", str(tmp_path / "logs"), "--input_pipeline", "npz", "--data_dir", str(sandbox),
        "--batch_size", "4", "--num_examples_override", "4", "--img_size", str(IMG),
        "--max_silhouette_points", "256", "--encoder_stage_sizes", "1,1,1,1", "--encoder_dtype", "float32",
        "--use_validation", "false", "--log_img_step", "0", "--checkpoint_every_epochs", "1000",
    ], device="cpu")
    for ab in train_many.ABLATIONS:
        assert ckpt.latest_step(f"{tmp_path / 'ck'}_{ab['suffix']}") == 1
    runs = sorted(os.listdir(tmp_path / "logs"))
    assert sorted(r.split("_")[1] for r in runs) == ["kp", "mr", "mr"]
    for r in runs:
        assert os.path.isfile(tmp_path / "logs" / r / "params.json")


# ---------------------------------------------------------------------------
# viz/datasets.py


def test_dataset_visualizers_match_jax(tmp_path, tiny_model, rng):
    """tests/test_predictor_viz.py::test_dataset_visualizers's inputs: both
    files written; the rendered vertices within 1e-5 of the JAX path's and
    every panel equal to the JAX renderer's (numpy rasterizer)."""
    from human_pose_estimation_tpu.core.smpl import smpl_forward as jsmpl_forward
    from human_pose_estimation_tpu.viz import datasets as jdatasets
    from human_pose_estimation_tpu.viz import renderer as jrenderer
    from human_pose_estimation_tpu_torch.train.step import GenBatch
    from human_pose_estimation_tpu_torch.viz import datasets

    batch = GenBatch(
        images=torch.from_numpy(rng.rand(2, 32, 32, 3) * 2 - 1),
        seg_points=torch.from_numpy(rng.rand(2, 16, 2) * 32),
        seg_mask=torch.ones(2, 16),
        kp2d=torch.from_numpy(rng.rand(2, 19, 3)),
    )
    assert os.path.exists(datasets.show_image_batch(batch, out_path=str(tmp_path / "b.png")))
    poses = rng.randn(1, 72).astype(np.float32) * 0.1
    shapes = rng.randn(1, 10).astype(np.float32) * 0.1
    smpl = synthetic_model(num_verts=120, seed=0)
    kw = dict(angles=(0.0, 90.0), img_size=48)
    assert os.path.exists(datasets.draw_smpl_meshes(smpl, poses, shapes, out_path=str(tmp_path / "m.png"), **kw))

    ref = np.asarray(jsmpl_forward(tiny_model, jnp.asarray(shapes), jnp.asarray(poses)).verts) + np.array([0, 0, 2.5])
    np.testing.assert_allclose(datasets.posed_vertices(smpl, poses, shapes), ref, atol=1e-5)
    ours = datasets.draw_smpl_meshes(smpl, poses, shapes, **kw)
    orig = jrenderer.rasterize_mesh
    jrenderer.rasterize_mesh = functools.partial(orig, use_native=False)
    try:
        theirs = jdatasets.draw_smpl_meshes(tiny_model, poses, shapes, **kw)
    finally:
        jrenderer.rasterize_mesh = orig
    for a, b in zip(ours.axes, theirs.axes):
        np.testing.assert_array_equal(a.images[0].get_array(), b.images[0].get_array())


# ---------------------------------------------------------------------------
# cli/preview.py


@pytest.fixture(scope="module")
def predictors(tiny_model):
    """The JAX Predictor (as tests/test_predictor_viz.py builds it) and the
    port's on the same bridged weights, encoder (1, 1, 1, 1), 64 px."""
    from human_pose_estimation_tpu.config import Config as JConfig
    from human_pose_estimation_tpu.infer.predictor import Predictor as JPredictor
    from human_pose_estimation_tpu.models.hmr import HMR as JHMR
    from human_pose_estimation_tpu.utils.assets import synthetic_mean_params
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor
    from human_pose_estimation_tpu_torch.models import port_jax

    jp = JPredictor.__new__(JPredictor)
    jp.config = JConfig(img_size=64, batch_size=1, encoder_dtype="float32")
    jp.batch_size, jp.smpl = 1, tiny_model
    jp.hmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=(1, 1, 1, 1))
    jp.variables = jax.jit(lambda key: jp.hmr.init(key, img_size=64))(jax.random.PRNGKey(0))  # eager init: ~2x
    jp.mean_theta = jnp.asarray(synthetic_mean_params()[None, :])
    jp._predict = jax.jit(jp._predict_impl)
    cfg = Config(img_size=64, batch_size=1, encoder_dtype="float32", encoder_stage_sizes="1,1,1,1")
    tp = Predictor(cfg, smpl=synthetic_model(num_verts=120, seed=0),
                   variables=port_jax.hmr_state_dict(jax.tree.map(np.asarray, jp.variables)),
                   mean_theta=synthetic_mean_params()[None, :], batch_size=1, device="cpu")
    return jp, tp


@pytest.mark.parametrize("mode", ["s", "m", "r", "b"])
def test_annotate_frame_matches_jax(predictors, tiny_model, mode):
    from human_pose_estimation_tpu.cli import preview as jpreview
    from human_pose_estimation_tpu.viz import renderer as jrenderer
    from human_pose_estimation_tpu_torch.cli import preview
    from human_pose_estimation_tpu_torch.viz.renderer import SMPLRenderer

    jp, tp = predictors
    frame = (np.random.RandomState(7).rand(90, 70, 3) * 255).astype(np.uint8)
    faces = np.asarray(tiny_model.faces, np.int64)
    ours = preview.annotate_frame(frame, tp, SMPLRenderer(img_size=64, faces=faces), 64, mode)
    orig = jrenderer.rasterize_mesh
    jrenderer.rasterize_mesh = functools.partial(orig, use_native=False)
    try:
        theirs = jpreview.annotate_frame(frame, jp, jrenderer.SMPLRenderer(img_size=64, faces=faces), 64, mode)
    finally:
        jrenderer.rasterize_mesh = orig
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape == frame.shape
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2
    if mode == "b":
        np.testing.assert_array_equal(ours, frame)


def test_preview_main_writes_the_annotated_image(tmp_path):
    from human_pose_estimation_tpu_torch.cli import preview

    model_path = str(tmp_path / "model.npz")
    save_model_npz(synthetic_model(num_verts=120, seed=0), model_path)
    image, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    cv2.imwrite(image, (np.random.RandomState(8).rand(90, 70, 3) * 255).astype(np.uint8))
    preview.main(["--image", image, "--out", out, "--smpl_model_path", model_path, "--img_size", "64",
                  "--encoder_stage_sizes", "1,1,1,1", "--encoder_dtype", "float32",
                  "--checkpoint_dir", str(tmp_path / "none")], device="cpu")
    assert cv2.imread(out).shape == (90, 70, 3)
