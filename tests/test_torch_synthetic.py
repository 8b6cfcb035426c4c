"""The port's closed-loop synthetic ground truth against the JAX package's,
on the CPU: ``utils/synthetic_human.py`` (the rigged capsule body, numpy
throughout: bit-equal), ``data/synthetic.py`` (the samplers bit-equal for
the same ``RandomState``; renders and pixel keypoints from both packages'
body-model forwards; whole datasets in both formats), the
``create_synthetic`` command line, and ``core/smpl.save_model_npz``.

Each test names its seeds and tolerances. The two packages' body-model
forwards agree to f32 rounding, so renders of their vertices may differ
at a few edge pixels (masks held to 99.9% of pixels) and keypoints by
ulps (1e-4 px).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.core.smpl import smpl_forward as jsmpl_forward
from human_pose_estimation_tpu.data import synthetic as jsynthetic
from human_pose_estimation_tpu.utils.synthetic_human import synthetic_human_model as jsynthetic_human_model
from human_pose_estimation_tpu_torch.core.smpl import load_model, load_model_npz, save_model_npz, smpl_forward
from human_pose_estimation_tpu_torch.data import synthetic
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model
from human_pose_estimation_tpu_torch.utils.synthetic_human import synthetic_human_model

FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "joint_regressor")


@pytest.fixture(scope="module")
def small_models():
    """The 900-vertex, ring-8 body of the convergence test, from both
    packages (seed 0)."""
    return synthetic_human_model(num_verts=900, ring_size=8), jsynthetic_human_model(num_verts=900, ring_size=8)


@pytest.mark.parametrize("num_verts", [900, 6890])
@pytest.mark.parametrize("ring_size", [8, 12])
def test_synthetic_human_model_is_bit_equal(num_verts, ring_size):
    """Every array, the faces and the parents equal bit for bit to the JAX
    function's (seed 0; seed 3 for the 900-vertex ring-8 body, whose
    blendshape noise it draws); ``device='cpu'`` gives the same tensors."""
    seed = 3 if (num_verts, ring_size) == (900, 8) else 0
    m = synthetic_human_model(num_verts=num_verts, ring_size=ring_size, seed=seed)
    j = jsynthetic_human_model(num_verts=num_verts, ring_size=ring_size, seed=seed, as_jax=False)
    assert m.num_verts == num_verts
    for f in FIELDS:
        got, want = getattr(m, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert m.faces.dtype == j.faces.dtype and np.array_equal(m.faces, j.faces)
    assert m.parents == tuple(j.parents)
    on_cpu = synthetic_human_model(num_verts=num_verts, ring_size=ring_size, seed=seed, device="cpu")
    assert all(torch.equal(getattr(on_cpu, f), getattr(m, f)) for f in FIELDS)


def test_samplers_are_bit_equal():
    """``sample_poses`` (default and scaled), ``sample_betas`` and
    ``sample_cams`` draw the same arrays from the same RandomState (seeds 0
    and 5), in sequence; ``axis_angle_from_matrix`` agrees on random
    rotations and on the near-pi branch."""
    for seed in (0, 5):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        for draw in (
            lambda m, r: m.sample_poses(r, 7),
            lambda m, r: m.sample_poses(r, 3, yaw_range=0.3, sigma_scale=1.5),
            lambda m, r: m.sample_betas(r, 7),
            lambda m, r: m.sample_betas(r, 4, scale=2.5),
            lambda m, r: m.sample_cams(r, 7),
            lambda m, r: m.sample_cams(r, 2, s_range=(0.3, 0.4), t_max=0.2),
        ):
            got, want = draw(synthetic, a), draw(jsynthetic, b)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(1)
    mats = [synthetic._rot_x(rng.uniform(-3, 3)) @ synthetic._rot_y(rng.uniform(-3, 3)) for _ in range(5)]
    mats += [synthetic._rot_x(np.pi), synthetic._rot_y(np.pi - 1e-7) @ synthetic._rot_z(1e-9), np.eye(3)]
    for r in mats:
        np.testing.assert_array_equal(synthetic.axis_angle_from_matrix(r), jsynthetic.axis_angle_from_matrix(r))


def test_render_example_and_keypoints_match_jax(small_models):
    """Renders of 6 sampled bodies (seed 2) at 64 px from each package's
    body-model forward: the silhouettes agree on at least 99.9% of the
    pixels, the pixel keypoints within 1e-4 px; the port's render of the
    JAX vertices is element-equal to the JAX render (the same rasterizer
    and the same RandomState)."""
    model, jmodel = small_models
    rng = np.random.RandomState(2)
    thetas, betas, cams = synthetic.sample_poses(rng, 6), synthetic.sample_betas(rng, 6), synthetic.sample_cams(rng, 6)
    out = smpl_forward(model, torch.from_numpy(betas), torch.from_numpy(thetas), joint_type="lsp")
    jout = jsmpl_forward(jmodel, jnp.asarray(betas), jnp.asarray(thetas), joint_type="lsp")
    verts, jverts = out.verts.numpy(), np.asarray(jout.verts)
    joints, jjoints = out.joints.numpy(), np.asarray(jout.joints)
    for i in range(6):
        rgb, sil = synthetic.render_example(verts[i], model.faces, cams[i], 64, np.random.RandomState(i))
        jrgb, jsil = jsynthetic.render_example(jverts[i], jmodel.faces, cams[i], 64, np.random.RandomState(i))
        assert rgb.dtype == jrgb.dtype == np.uint8 and sil.shape == jsil.shape == (64, 64, 1)
        assert sil.any() and (sil == jsil).mean() >= 0.999
        same_rgb, same_sil = synthetic.render_example(jverts[i], model.faces, cams[i], 64, np.random.RandomState(i))
        np.testing.assert_array_equal(same_rgb, jrgb)
        np.testing.assert_array_equal(same_sil, jsil)
        np.testing.assert_allclose(
            synthetic.project_keypoints_px(joints[i], cams[i], 64),
            jsynthetic.project_keypoints_px(jjoints[i], cams[i], 64),
            rtol=0, atol=1e-4,
        )


def _decoded_labels(tf, path):
    """Every record's (label (3, 14), centre) from an image tfrecord."""
    from human_pose_estimation_tpu_torch.data import tfrecords

    out = []
    for rec in tf.data.TFRecordDataset([path]).as_numpy_iterator():
        parsed = tfrecords.parse_image_example(rec)
        out.append((parsed["label"].numpy()[:, :14], parsed["center"].numpy(), parsed["image"].shape))
    return out


@pytest.mark.parametrize("fmt", ["npz", "tfrecord"])
def test_generate_closed_loop_dataset_matches_jax(tmp_path, small_models, fmt):
    """The whole tree at 64 px with 16 train / 8 val examples and 64 mocap
    samples (seed 0), against the JAX function's: the same files,
    ``ground_truth.npz`` and the mocap prior equal, the same statistics
    keys and silhouette statistics, the decoded labels within 1e-4 px and
    the centres equal."""
    model, jmodel = small_models
    if fmt == "tfrecord":
        tf = pytest.importorskip("tensorflow")
    pytest.importorskip("cv2")
    kw = dict(n_train=16, n_val=8, n_mocap=64, img_size=64, seed=0, fmt=fmt)
    stats = synthetic.generate_closed_loop_dataset(str(tmp_path / "port"), model, device="cpu", **kw)
    jstats = jsynthetic.generate_closed_loop_dataset(str(tmp_path / "jax"), jmodel, **kw)
    assert stats.keys() == jstats.keys()
    assert stats == jstats
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    gt, jgt = np.load(tmp_path / "port" / "ground_truth.npz"), np.load(tmp_path / "jax" / "ground_truth.npz")
    assert sorted(gt.files) == sorted(jgt.files) == sorted(
        f"{s}_{k}" for s in ("lsp_train", "lsp_val") for k in ("theta", "beta", "cam")
    )
    for k in gt.files:
        np.testing.assert_array_equal(gt[k], jgt[k])
    mdir = "mocap_neutrMosh"
    if fmt == "npz":
        for split in ("lsp_train", "lsp_val"):
            z, jz = np.load(tmp_path / "port" / f"{split}.npz", allow_pickle=True), np.load(
                tmp_path / "jax" / f"{split}.npz", allow_pickle=True
            )
            np.testing.assert_allclose(z["label"], jz["label"], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(z["center"], jz["center"])
            assert len(z["jpeg"]) == len(jz["jpeg"])
        m, jm = np.load(tmp_path / "port" / mdir / "neutrSMPL_CMU_synth.npz"), np.load(
            tmp_path / "jax" / mdir / "neutrSMPL_CMU_synth.npz"
        )
        for k in ("pose", "shape"):
            np.testing.assert_array_equal(m[k], jm[k])
    else:
        for split in ("lsp_train", "lsp_val"):
            got = _decoded_labels(tf, str(tmp_path / "port" / f"{split}.tfrecords"))
            want = _decoded_labels(tf, str(tmp_path / "jax" / f"{split}.tfrecords"))
            assert len(got) == len(want) == kw["n_train" if split == "lsp_train" else "n_val"]
            for (lab, cen, shape), (jlab, jcen, jshape) in zip(got, want):
                np.testing.assert_allclose(lab, jlab, rtol=0, atol=1e-4)
                np.testing.assert_array_equal(cen, jcen)
                assert shape == jshape == (64, 64, 3)
        a = (tmp_path / "port" / mdir / "neutrSMPL_CMU_synth.tfrecord").read_bytes()
        assert a == (tmp_path / "jax" / mdir / "neutrSMPL_CMU_synth.tfrecord").read_bytes()


def test_render_split_holds_the_written_split(small_models):
    """``render_split`` returns what ``generate_closed_loop_dataset``
    writes for a split, in memory (seed 0 + 1, the train split's stream):
    its parameters equal the JAX dataset's ground truth, its labels are
    (3, 14) with the in-frame flags, its silhouettes non-empty."""
    model, _ = small_models
    examples, params, sil = synthetic.render_split(model, 5, np.random.RandomState(1), img_size=64, device="cpu")
    rng = np.random.RandomState(1)
    np.testing.assert_array_equal(params["theta"], jsynthetic.sample_poses(rng, 5))
    np.testing.assert_array_equal(params["beta"], jsynthetic.sample_betas(rng, 5))
    np.testing.assert_array_equal(params["cam"], jsynthetic.sample_cams(rng, 5))
    assert len(examples) == len(sil) == 5
    for (rgb, s, label), count in zip(examples, sil):
        assert rgb.shape == (64, 64, 3) and s.shape == (64, 64, 1) and label.shape == (3, 14)
        assert label.dtype == np.float32 and set(np.unique(label[2])) <= {0.0, 1.0}
        assert count == int((s > 0).sum()) > 0
    assert set(synthetic.sil_stats(sil)) == {"sil_pixels_mean", "sil_pixels_p50", "sil_pixels_p99", "sil_pixels_max"}
    np.testing.assert_array_equal(synthetic._center_from_label(examples[0][2]), jsynthetic._center_from_label(examples[0][2]))


def test_silhouette_statistics_at_full_size_match_jax():
    """The quality bench's data at full size: 512 train and 128 val
    renders of the 6890-vertex body at 256 px from seed 0's split streams
    (seeds 1 and 2), by the JAX generator (its samplers, body-model
    forward in batches of 64 and ``render_example``, as
    ``generate_closed_loop_dataset`` runs them) and by the port's
    ``render_split`` on the CPU. Each render's silhouette pixel count is
    within 0.1% of the image's pixels (65) of the JAX one's, the masks'
    99.9% tolerance; the statistics that ``sil_stats`` reports (QUALITY.md's
    four) are printed for both (``-s``)."""
    model, jmodel = synthetic_human_model(num_verts=6890), jsynthetic_human_model(num_verts=6890)
    faces = np.asarray(jmodel.faces)
    got, want = [], []
    for n, seed in ((512, 1), (128, 2)):
        got += synthetic.render_split(model, n, np.random.RandomState(seed), img_size=256, device="cpu")[2]
        rng = np.random.RandomState(seed)
        thetas, betas = jsynthetic.sample_poses(rng, n), jsynthetic.sample_betas(rng, n)
        cams = jsynthetic.sample_cams(rng, n)
        for s0 in range(0, n, 64):
            sl = slice(s0, s0 + 64)
            jout = jsmpl_forward(jmodel, jnp.asarray(betas[sl]), jnp.asarray(thetas[sl]), joint_type="lsp")
            for v, cam in zip(np.asarray(jout.verts), cams[sl]):
                want.append(int(jsynthetic.render_example(v, faces, cam, 256, rng)[1].astype(bool).sum()))
    got, want = np.asarray(got), np.asarray(want)
    print(f"\nport {synthetic.sil_stats(got)}\njax  {synthetic.sil_stats(want)}\nrenders that differ: {(got != want).sum()}")
    assert len(got) == len(want) == 640
    assert np.abs(got - want).max() <= 65


def test_create_synthetic_cli(tmp_path):
    """``main(argv, device='cpu')`` writes the npz tree and the generating
    body model; the statistics equal the library call's and the saved body
    model loads back equal to ``synthetic_human_model``'s."""
    pytest.importorskip("cv2")
    out = tmp_path / "synth"
    from human_pose_estimation_tpu_torch.cli import create_synthetic

    argv = ["--out_dir", str(out), "--n_train", "4", "--n_val", "2", "--n_mocap", "12", "--img_size", "48",
            "--num_verts", "900", "--fmt", "npz", "--model_out", str(tmp_path / "model.npz")]
    stats = create_synthetic.main(argv, device="cpu")
    assert stats["n_train"] == 4 and stats["n_val"] == 2 and stats["n_mocap"] == 12
    assert {"lsp_train.npz", "lsp_val.npz", "ground_truth.npz", "mocap_neutrMosh"} <= set(os.listdir(out))
    model = synthetic_human_model(num_verts=900)
    ref = synthetic.generate_closed_loop_dataset(
        str(tmp_path / "ref"), model, n_train=4, n_val=2, n_mocap=12, img_size=48, fmt="npz", device="cpu"
    )
    assert stats == ref
    loaded = load_model(str(tmp_path / "model.npz"))
    assert all(torch.equal(getattr(loaded, f), getattr(model, f)) for f in FIELDS)


@pytest.mark.parametrize("faces", [True, False])
def test_save_model_npz_round_trip(tmp_path, faces):
    """``save_model_npz`` then ``load_model_npz``: every tensor, the parents
    and the faces equal; a model without faces comes back without; the
    file loads into the JAX package's ``load_model_npz`` equal too."""
    from human_pose_estimation_tpu.core.smpl import load_model_npz as jload_model_npz

    model = synthetic_human_model(num_verts=900, ring_size=8) if faces else synthetic_model(num_verts=50, seed=4)
    if not faces:
        model.faces = None
    path = str(tmp_path / "model.npz")
    save_model_npz(model, path)
    back = load_model_npz(path)
    for f in FIELDS:
        assert getattr(back, f).dtype == torch.float32
        assert torch.equal(getattr(back, f), getattr(model, f)), f
    assert back.parents == model.parents
    assert (back.faces is None) if not faces else np.array_equal(back.faces, model.faces)
    jback = jload_model_npz(path)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)), getattr(model, f).numpy())
    on_device = model.to("cpu")
    save_model_npz(on_device, str(tmp_path / "again.npz"))
    again = np.load(str(tmp_path / "again.npz"))
    assert again["parents"].dtype == np.int32 and again["faces"].shape[1] == 3
