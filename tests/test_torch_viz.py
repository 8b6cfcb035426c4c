"""The port's own copies of host-side modules against the JAX package's, on
the same numpy inputs: ``viz/renderer.py`` (the numpy rasterizer,
``SMPLRenderer``, ``get_original``, ``draw_skeleton``, ``draw_text``),
``utils/image.py`` (the predict CLI's preprocessing) and
``data/tfrecords.py`` (writers, parsers, the dataset-size table).

Every output is compared exactly: the port's copies run the same numpy,
OpenCV and TensorFlow calls. Both packages' ``rasterize_mesh`` take their
C++ rasterizer for flat shading by default; the port's ``SMPLRenderer``
(on its C++ rasterizer) is held against the JAX renderer pinned to its
numpy rasterizer, the C++ one's own specification.
"""
import functools

import numpy as np
import pytest

from human_pose_estimation_tpu.data import tfrecords as jtfrecords
from human_pose_estimation_tpu.utils import image as jimage
from human_pose_estimation_tpu.viz import renderer as jviz
from human_pose_estimation_tpu_torch.data import tfrecords
from human_pose_estimation_tpu_torch.utils import image
from human_pose_estimation_tpu_torch.viz import renderer as viz


@pytest.fixture(scope="module")
def mesh(tiny_model):
    verts = np.asarray(tiny_model.v_template, np.float64) + np.array([0.0, 0.0, 4.0])
    return verts, np.asarray(tiny_model.faces, np.int64)


@pytest.fixture
def jax_numpy_raster(monkeypatch):
    """The JAX renderer on its numpy rasterizer (the port's only one)."""
    monkeypatch.setattr(jviz, "rasterize_mesh", functools.partial(jviz.rasterize_mesh, use_native=False))


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# viz/renderer.py


@pytest.mark.parametrize("lighting", ["directional", "points"])
@pytest.mark.parametrize("background", [False, True])
def test_rasterize_mesh_matches_jax(mesh, lighting, background):
    verts, faces = mesh
    bg = np.random.RandomState(1).rand(72, 80, 3) if background else None
    kw = dict(height=72, width=80, focal=110.0, center=np.array([41.0, 35.5]), color=viz.MESH_COLORS[1],
              background=bg, lighting=lighting)
    img, mask = viz.rasterize_mesh(verts, faces, use_native=False, **kw)
    assert mask.any() and not mask.all()
    _assert_same((img, mask), jviz.rasterize_mesh(verts, faces, use_native=False, **kw))
    # the C++ rasterizer (flat shading; 'points' stays on numpy in both
    # packages): element-equal to the JAX package's C++ build, its masks
    # element-equal to the numpy path and its images within 1e-12
    nimg, nmask = viz.rasterize_mesh(verts, faces, use_native=True, **kw)
    _assert_same((nimg, nmask), jviz.rasterize_mesh(verts, faces, use_native=True, **kw))
    np.testing.assert_array_equal(nmask, mask)
    np.testing.assert_allclose(nimg, img, rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "call",
    [
        dict(),
        dict(ssaa=2, do_alpha=True, color_id=1),
        dict(img="float", ssaa=2),
        dict(img="uint8", lighting="points"),
        dict(img_size=(48, 56), cam=None),
    ],
)
def test_smpl_renderer_matches_jax(mesh, jax_numpy_raster, call):
    verts, faces = mesh
    rng = np.random.RandomState(2)
    call = dict(call)
    if call.get("img") == "float":
        call["img"] = rng.rand(64, 64, 3)
    elif call.get("img") == "uint8":
        call["img"] = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    call.setdefault("cam", [96.0, 30.0, 33.0])
    got = viz.SMPLRenderer(img_size=64, faces=faces)(verts, **call)
    want = jviz.SMPLRenderer(img_size=64, faces=faces)(verts, **call)
    assert got.dtype == np.uint8 and (got != 255).any()
    _assert_same(got, want)
    rot = dict(cam=[96.0, 30.0, 33.0], axis="x", ssaa=2)
    _assert_same(viz.SMPLRenderer(img_size=64, faces=faces).rotated(verts, 30, **rot),
                 jviz.SMPLRenderer(img_size=64, faces=faces).rotated(verts, 30, **rot))


def test_get_original_matches_jax(mesh):
    verts, _ = mesh
    rng = np.random.RandomState(3)
    for scale, start, size in ((0.5, [10.0, 20.0], 224), (1.7, [3, 140], 64)):
        proc = {"scale": scale, "start_pt": np.asarray(start), "img_size": size}
        cam = np.array([0.9, 0.1, -0.2]) + rng.rand(3) * 0.1
        joints = rng.rand(19, 2) * size
        _assert_same(viz.get_original(proc, verts, cam, joints), jviz.get_original(proc, verts, cam, joints))


def test_draw_skeleton_and_text_match_jax():
    rng = np.random.RandomState(4)
    joints = rng.rand(19, 2) * 64
    vis = rng.rand(19) > 0.3
    for img in (rng.rand(64, 64, 3).astype(np.float32), (rng.rand(64, 72, 3) * 255).astype(np.uint8)):
        for kw in (dict(), dict(vis=vis), dict(draw_edges=False, vis=vis), dict(radius=6)):
            _assert_same(viz.draw_skeleton(img, joints, **kw), jviz.draw_skeleton(img, joints, **kw))
        _assert_same(viz.draw_skeleton(img, joints[:14].T), jviz.draw_skeleton(img, joints[:14].T))
        content = {"sc": 0.9, "tx": -0.12, "kpl": 1.23}
        _assert_same(viz.draw_text(img, content), jviz.draw_text(img, content))


# ---------------------------------------------------------------------------
# utils/image.py


@pytest.mark.parametrize("shape,size", [((100, 80, 3), 64), ((61, 130, 3), 224), ((90, 90, 4), 56)])
def test_preprocess_for_inference_matches_jax(shape, size):
    img = (np.random.RandomState(5).rand(*shape) * 255).astype(np.uint8)
    got, want = image.preprocess_for_inference(img, size), jimage.preprocess_for_inference(img, size)
    assert got[0].shape == (size, size, 3)
    _assert_same(got, want)
    center = np.array([shape[1] // 3, shape[0] // 2])
    _assert_same(image.scale_and_crop(img[..., :3], 0.7, center, size),
                 jimage.scale_and_crop(img[..., :3], 0.7, center, size))


def test_load_calibration_images_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(6)
    for i, (h, w) in enumerate(((50, 70), (80, 40), (64, 64))):
        cv2.imwrite(str(tmp_path / f"c{i}.jpg"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
    (tmp_path / "broken.jpg").write_bytes(b"not an image")
    pattern = str(tmp_path / "*.jpg")
    got = image.load_calibration_images(pattern, img_size=48, limit=3)
    assert got.shape == (2, 48, 48, 3)  # the sorted first three hold one unreadable file
    _assert_same(got, jimage.load_calibration_images(pattern, img_size=48, limit=3))
    paths = [str(tmp_path / "c2.jpg"), str(tmp_path / "c0.jpg")]
    _assert_same(image.load_calibration_images(paths, img_size=32), jimage.load_calibration_images(paths, img_size=32))
    assert image.load_calibration_images(str(tmp_path / "none*.jpg")) is None


# ---------------------------------------------------------------------------
# data/tfrecords.py


def test_tfrecords_tables_and_helpers_match_jax(tmp_path):
    assert tfrecords.NUM_EXAMPLES == jtfrecords.NUM_EXAMPLES
    assert tfrecords.MPII_TO_LSP == jtfrecords.MPII_TO_LSP
    for names in (["lsp_train", "lsp_ext"], "CMU", ["lsp_16"]):
        assert tfrecords.num_examples(names) == jtfrecords.num_examples(names)
    (tmp_path / "lsp_16.tfrecords").write_bytes(b"")
    (tmp_path / "mocap_neutrMosh").mkdir()
    for name in ("neutrSMPL_CMU_1.tfrecord", "neutrSMPL_CMU_0.tfrecord", "neutrSMPL_jointLim_0.tfrecord"):
        (tmp_path / "mocap_neutrMosh" / name).write_bytes(b"")
    d = str(tmp_path)
    assert tfrecords.record_files(d, ["lsp_16", "lsp_val"]) == jtfrecords.record_files(d, ["lsp_16", "lsp_val"])
    assert tfrecords.mocap_record_files(d, ["CMU", "jointLim"]) == jtfrecords.mocap_record_files(d, ["CMU", "jointLim"])
    with pytest.raises(ValueError, match="h36m"):
        tfrecords.record_files(d, ["h36m"])

    img, seg, ext_img, ext_seg = (tmp_path / n for n in ("img", "seg", "ext_img", "ext_seg"))
    for p in (img, seg, ext_img, ext_seg):
        p.mkdir()
    for i in range(4):
        (img / f"im{i:04d}.jpg").write_bytes(b"")
        if i != 2:  # an image without its segmentation is skipped
            (seg / f"im{i:04d}_segmentation.png").write_bytes(b"")
        (ext_seg / f"im{i:05d}_part.png").write_bytes(b"")
    assert tfrecords.pair_lsp(str(img), str(seg)) == jtfrecords.pair_lsp(str(img), str(seg))
    assert len(tfrecords.pair_lsp(str(img), str(seg))) == 3
    assert tfrecords.pair_lsp_ext(str(ext_img), str(ext_seg)) == jtfrecords.pair_lsp_ext(str(ext_img), str(ext_seg))
    label = np.random.RandomState(7).rand(3, 14).astype(np.float32) * 50
    label[2] = label[2] > 20
    _assert_same(tfrecords.center_from_visible(label), jtfrecords.center_from_visible(label))


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _records(tf, path):
    return [r.numpy() for r in tf.data.TFRecordDataset(path)]


@pytest.mark.parametrize("mode", ["lsp", "mpii"])
def test_image_tfrecord_write_parse_round_trip_matches_jax(tf, tmp_path, mode):
    """Both packages write the same bytes from the same files, and each
    parses the other's records to the same tensors."""
    rng = np.random.RandomState(8)
    k = 16 if mode == "mpii" else 14
    n = 4
    joints = np.zeros((3, k, n), np.float32)
    pairs = []
    for i in range(n):
        h, w = int(rng.randint(40, 90)), int(rng.randint(40, 90))
        ip, sp = str(tmp_path / f"im{i:04d}.jpg"), str(tmp_path / f"im{i:04d}_segmentation.png")
        tf.io.write_file(ip, tf.io.encode_jpeg((rng.rand(h, w, 3) * 255).astype(np.uint8)))
        seg = ((rng.rand(h, w, 3 if i % 2 else 1) > 0.5) * 255).astype(np.uint8)  # 3- and 1-channel
        tf.io.write_file(sp, tf.io.encode_png(seg))
        joints[0, :, i], joints[1, :, i] = rng.rand(k) * (w - 1), rng.rand(k) * (h - 1)
        joints[2, :, i] = rng.rand(k) > 0.3
        pairs.append((ip, sp))
    joints[2, :, 1] = 0.0 if mode == "mpii" else 1.0  # no visible joint (after LSP's inversion): skipped
    kw = dict(joint_order=tfrecords.MPII_TO_LSP) if mode == "mpii" else dict(visibility_inverted=True)
    ours, theirs = str(tmp_path / "port.tfrecords"), str(tmp_path / "jax.tfrecords")
    assert tfrecords.create_image_tfrecord(ours, pairs, joints, **kw) == 3
    assert jtfrecords.create_image_tfrecord(theirs, pairs, joints, **kw) == 3
    records = _records(tf, ours)
    assert records == _records(tf, theirs)
    for rec in records:
        got = {k: v.numpy() for k, v in tfrecords.parse_image_example(rec).items()}
        assert got["label"].shape == (3, 19) and got["seg"].shape[-1] == 1
        _assert_same(got, {k: v.numpy() for k, v in jtfrecords.parse_image_example(rec).items()})


def test_mocap_tfrecord_write_parse_round_trip_matches_jax(tf, tmp_path):
    rng = np.random.RandomState(9)
    poses, shapes = rng.randn(5, 72) * 0.3, rng.randn(5, 10) * 0.5
    ours, theirs = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    assert tfrecords.create_mocap_tfrecord(ours, poses, shapes) == jtfrecords.create_mocap_tfrecord(theirs, poses, shapes)
    records = _records(tf, ours)
    assert records == _records(tf, theirs) and len(records) == 5
    for rec, pose, shape in zip(records, poses, shapes):
        got = [t.numpy() for t in tfrecords.parse_mocap_example_tf(rec)]
        _assert_same(got, [t.numpy() for t in jtfrecords.parse_mocap_example_tf(rec)])
        _assert_same(got, [pose.astype(np.float32), shape.astype(np.float32)])
    one = tfrecords.make_mocap_example(poses[0], shapes[0]).SerializeToString()
    assert one == jtfrecords.make_mocap_example(poses[0], shapes[0]).SerializeToString()
