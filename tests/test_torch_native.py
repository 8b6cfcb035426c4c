"""The port's host input layers against the JAX package's, on the CPU:

* ``native/`` — the C++ rasterizer (its copy of ``rasterizer.cpp``, built
  into ``build/native/``) element-equal to the JAX package's build and
  to its own numpy path; the C++ batch decoder (``decode_fit_batch``)
  against OpenCV and against the JAX package's build;
* ``data/native_pipeline.NativeImagePipeline`` against the port's
  ``NpzImagePipeline`` and the JAX ``NativeImagePipeline`` on one shard;
* the tf.data ``ImagePipeline`` / ``MocapPipeline`` of ``data/pipeline.py``
  against the JAX ones on the same tfrecords (``tests/test_pipeline.py``
  is the model);
* the factories of ``data/__init__.py`` for ``tfrecord`` and ``native``.

Every input is made from a seeded numpy ``RandomState``; each test states
its tolerance. Host batches from the same decoder are compared exactly;
batches through the device augmentation within 1e-5 (the port's
augmentation against JAX's, ``tests/test_torch_data.py``).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from human_pose_estimation_tpu import native as jnative
from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.viz import renderer as jviz
from human_pose_estimation_tpu_torch import data as tdata
from human_pose_estimation_tpu_torch import native
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.data import npz_dataset as tnpz
from human_pose_estimation_tpu_torch.train.step import HostBatch
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model
from human_pose_estimation_tpu_torch.utils.synthetic_human import synthetic_human_model
from human_pose_estimation_tpu_torch.viz import renderer as viz

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _genbatch_close(got, want, atol=ATOL, n=None):
    """A port GenBatch against a JAX one over its first ``n`` rows (default
    all): images and keypoints within ``atol``, silhouettes element-equal."""
    for name in ("images", "kp2d"):
        np.testing.assert_allclose(
            getattr(got, name).numpy()[:n], np.asarray(getattr(want, name))[:n], rtol=0, atol=atol
        )
    for name in ("seg_points", "seg_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:n], np.asarray(getattr(want, name))[:n])


def _hostbatch_equal(got, want, n=None):
    assert isinstance(got, HostBatch)
    for name in ("image", "seg", "hw", "center", "label"):
        g, w = np.asarray(getattr(got, name))[:n], np.asarray(getattr(want, name))[:n]
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# native/rasterizer.cpp


def test_native_libraries_build_into_the_build_directory():
    """Both libraries build with g++ into build/native/ under the repository
    root (never into the package); a build in this process records its
    seconds and its log."""
    assert native.get_rasterizer() is not None and native.get_dataloader() is not None
    built = sorted(os.listdir(os.path.join(REPO, "build", "native")))
    assert any(f.startswith("librasterizer_") and f.endswith(".so") for f in built)
    assert any(f.startswith("libdataloader_") and f.endswith(".so") for f in built)
    pkg = os.path.join(REPO, "human_pose_estimation_tpu_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    for name, seconds in native.BUILD_SECONDS.items():
        assert seconds > 0 and name in native.BUILD_LOG


@pytest.fixture(scope="module")
def human_mesh():
    """The 6890-vertex synthetic human, posed at rest 50 units from the
    camera (the closed-loop renders' placement, s = 0.7)."""
    m = synthetic_human_model(num_verts=6890)
    verts = m.v_template.numpy().astype(np.float64) + np.array([0.02, -0.03, 50.0 / 0.7])
    return verts, np.asarray(m.faces, np.int64)


@pytest.mark.parametrize("mesh_name", ["blob", "human"])
@pytest.mark.parametrize("background", [False, True])
def test_native_rasterizer_matches_jax_native_and_numpy(human_mesh, mesh_name, background):
    """The port's C++ rasterizer is element-equal to the JAX package's (the
    same source and flags); against its own numpy path the masks are
    element-equal and the images agree within 1e-12 (the two evaluate the
    same shading expression in a different order)."""
    if mesh_name == "human":
        verts, faces = human_mesh
        size, focal = 256, 0.5 * 256 * 50.0
    else:
        m = synthetic_model(num_verts=300, seed=0)
        verts = m.v_template.numpy().astype(np.float64) + np.array([0.0, 0.0, 4.0])
        faces, size, focal = np.asarray(m.faces, np.int64), 96, 120.0
    bg = np.random.RandomState(1).rand(size, size, 3) if background else None
    center = np.array([size / 2.0, size / 2.0])
    color = np.array([0.68, 0.58, 0.48])
    img, mask = viz.rasterize_mesh(verts, faces, size, size, focal, center, color, background=bg)
    assert mask.any() and not mask.all()
    jimg, jmask = jnative.rasterize_native(
        verts, faces, size, size, focal, center, color, jviz._LIGHT_DIR, jviz._AMBIENT, background=bg
    )
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(img, jimg)
    nimg, nmask = viz.rasterize_mesh(verts, faces, size, size, focal, center, color, background=bg, use_native=False)
    np.testing.assert_array_equal(mask, nmask)
    np.testing.assert_allclose(img, nimg, rtol=0, atol=1e-12)
    if background:
        np.testing.assert_array_equal(img[~mask], bg[~mask])


def test_rasterize_native_checks_its_buffers(human_mesh):
    """The library indexes its buffers unchecked, so shapes and face
    indices are checked before the call."""
    verts, faces = human_mesh
    args = (32, 32, 100.0, np.array([16.0, 16.0]), viz.MESH_COLORS[0], viz._LIGHT_DIR, viz._AMBIENT)
    with pytest.raises(ValueError, match="outside"):
        native.rasterize_native(verts[:100], faces, *args)
    with pytest.raises(ValueError, match="background"):
        native.rasterize_native(verts, faces, *args, background=np.zeros((32, 31, 3)))
    with pytest.raises(ValueError, match=r"\(V, 3\)"):
        native.rasterize_native(verts[:, :2], faces, *args)


def test_rasterize_mesh_falls_back_to_numpy_without_a_compiler(monkeypatch, human_mesh):
    """Where the C++ rasterizer cannot be built, ``rasterize_mesh`` takes
    its numpy path (the JAX package's fallback)."""
    verts, faces = human_mesh
    kw = dict(height=64, width=64, focal=0.5 * 64 * 50.0, center=np.array([32.0, 32.0]), color=viz.MESH_COLORS[0])
    monkeypatch.setattr(native, "rasterize_native", lambda *a, **k: None)
    img, mask = viz.rasterize_mesh(verts, faces, **kw)
    nimg, nmask = viz.rasterize_mesh(verts, faces, use_native=False, **kw)
    np.testing.assert_array_equal(img, nimg)
    np.testing.assert_array_equal(mask, nmask)


# ---------------------------------------------------------------------------
# native/dataloader.cpp


def _smooth_image(rng, h, w):
    """A smooth image, so that JPEG round trips stay near their input."""
    return np.clip(np.cumsum(rng.randn(h, w, 3), axis=1) * 5 + 128, 0, 255).astype(np.uint8)


def test_decode_fit_batch_matches_cv2_and_jax():
    """Decode and canvas fit against OpenCV (seed 0, 300x400 JPEG and PNG
    into a 256 canvas): the fit within 1 uint8 step of cv2.INTER_LINEAR,
    the padding zero, every lane equal; and every output element-equal to
    the JAX package's build of the same source."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    img = _smooth_image(rng, 300, 400)
    seg = ((rng.rand(300, 400) > 0.5) * 255).astype(np.uint8)
    jb = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1].tobytes()
    pb = cv2.imencode(".png", seg)[1].tobytes()
    canvas = 256
    out = native.decode_fit_batch([jb] * 3, [pb] * 3, canvas)
    nimg, nseg, hw, orig, off, scale, err = out
    assert (err == 0).all()
    dec = cv2.cvtColor(cv2.imdecode(np.frombuffer(jb, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    sdec = cv2.imdecode(np.frombuffer(pb, np.uint8), cv2.IMREAD_GRAYSCALE)
    h, w = dec.shape[:2]
    s = min(1.0, canvas / max(h, w))
    nh, nw = int(np.floor(h * s)), int(np.floor(w * s))
    assert tuple(hw[0]) == (nh, nw) and tuple(orig[0]) == (h, w)
    np.testing.assert_allclose(scale[0], [nh / h, nw / w], rtol=1e-6)
    rimg = cv2.resize(dec, (nw, nh), interpolation=cv2.INTER_LINEAR)
    rseg = cv2.resize(sdec, (nw, nh), interpolation=cv2.INTER_LINEAR)
    assert np.abs(nimg[0, :nh, :nw].astype(int) - rimg.astype(int)).max() <= 1
    assert np.abs(nseg[0, :nh, :nw, 0].astype(int) - rseg.astype(int)).max() <= 1
    assert nimg[0, nh:].max() == 0
    np.testing.assert_array_equal(nimg[0], nimg[2])
    for got, want in zip(out, jnative.decode_fit_batch([jb] * 3, [pb] * 3, canvas)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_decode_identity_size_is_exact():
    """A 64x48 JPEG into a 64 canvas: no resize, the decode element-equal
    to OpenCV's (seed 2)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(2)
    img = (rng.rand(64, 48, 3) * 255).astype(np.uint8)
    jb = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1].tobytes()
    nimg, _, hw, orig, off, scale, err = native.decode_fit_batch([jb], None, 64)
    dec = cv2.cvtColor(cv2.imdecode(np.frombuffer(jb, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert err[0] == 0 and tuple(hw[0]) == (64, 48) and tuple(orig[0]) == (64, 48)
    np.testing.assert_array_equal(nimg[0, :64, :48], dec)
    np.testing.assert_allclose(scale[0], [1.0, 1.0])


def test_decode_error_flags():
    """Bytes that are no JPEG or PNG flag their example and leave it zero."""
    nimg, nseg, hw, orig, off, scale, err = native.decode_fit_batch([b"notajpeg"], [b"notapng"], 32)
    assert err[0] != 0
    assert nimg.max() == 0 and nseg.max() == 0 and tuple(hw[0]) == (0, 0)
    with pytest.raises(ValueError):
        native.decode_fit_batch([b"x", b"y"], None, 32, centers=np.zeros((3, 2)), window_half=4)


# ---------------------------------------------------------------------------
# data/native_pipeline.py


def _write_shard(path, rng, sizes):
    """An npz image shard of smooth JPEGs and random PNG silhouettes with
    14 visible keypoints each, written with OpenCV."""
    cv2 = pytest.importorskip("cv2")
    jpegs, pngs, labels, centers = [], [], [], []
    for h, w in sizes:
        img = _smooth_image(rng, h, w)
        seg = ((rng.rand(h, w) > 0.5) * 255).astype(np.uint8)
        jpegs.append(cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1].tobytes())
        pngs.append(cv2.imencode(".png", seg)[1].tobytes())
        lab = np.stack([rng.rand(14) * (w - 1), rng.rand(14) * (h - 1), np.ones(14)]).astype(np.float32)
        labels.append(lab)
        centers.append([w // 2, h // 2])
    tnpz.write_npz_shard(path, jpegs, pngs, np.stack(labels), np.asarray(centers))
    return path


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_shard")
    rng = np.random.RandomState(1)
    return _write_shard(str(tmp / "lsp_5.npz"), rng, [(120 + i * 7, 90 + i * 11) for i in range(5)]), 5


def test_native_pipeline_matches_npz_pipeline_and_jax(shard):
    """Mode 'val' (one pass, no augmentation, the last batch padded): the
    port's native pipeline against its npz pipeline (the fit within one
    uint8 step: 2/255 after the [-1, 1] scale; keypoints within 1e-5;
    silhouette sizes within 8 pixels, the resize's rounding) and against
    the JAX native pipeline (host batches element-equal, GenBatches within
    1e-5, silhouettes element-equal)."""
    from human_pose_estimation_tpu.data.native_pipeline import NativeImagePipeline as JNative
    from human_pose_estimation_tpu_torch.data.native_pipeline import NativeImagePipeline

    npz, n = shard
    kw = dict(batch_size=2, img_size=64, max_silhouette_points=256)
    a = list(NativeImagePipeline(Config(**kw), [npz], mode="val", canvas=96, device="cpu"))
    b = list(tnpz.NpzImagePipeline(Config(**kw), [npz], mode="val", canvas=96, device="cpu"))
    assert [nv for _, nv in a] == [nv for _, nv in b] == [2, 2, 1]
    for (ba, _), (bb, _) in zip(a, b):
        assert (ba.images - bb.images).abs().max() <= 2.01 / 255
        np.testing.assert_allclose(ba.kp2d.numpy(), bb.kp2d.numpy(), rtol=0, atol=ATOL)
        assert abs(float(ba.seg_mask.sum()) - float(bb.seg_mask.sum())) <= 8

    ref = list(JNative(JConfig(**kw), [npz], mode="val", canvas=96))
    assert [nv for _, nv in ref] == [2, 2, 1]
    for (ba, _), (rb, _) in zip(a, ref):
        _genbatch_close(ba, rb)
    host = list(NativeImagePipeline(Config(**kw), [npz], mode="val", canvas=96, device_preprocess=False))
    jhost = list(JNative(JConfig(**kw), [npz], mode="val", canvas=96, device_preprocess=False))
    for (h, nv), (jh, jnv) in zip(host, jhost):
        assert nv == jnv
        _hostbatch_equal(h, jh)


def test_native_pipeline_train_mode_and_hostbatch(shard):
    """A repeating, shuffled stream: HostBatches for the fused step over
    more than one epoch in the JAX pipeline's order (seed 0; element-equal),
    and GenBatches through the augmentation (seed 7)."""
    from human_pose_estimation_tpu.data.native_pipeline import NativeImagePipeline as JNative
    from human_pose_estimation_tpu_torch.data.native_pipeline import NativeImagePipeline

    npz, n = shard
    kw = dict(batch_size=2, img_size=64, max_silhouette_points=128)
    it = iter(NativeImagePipeline(Config(**kw), [npz], mode="train", canvas=96, device_preprocess=False))
    jit = iter(JNative(JConfig(**kw), [npz], mode="train", canvas=96, device_preprocess=False))
    for _ in range(4):  # more than one epoch: the stream repeats
        (hb, nv), (jhb, jnv) = next(it), next(jit)
        assert nv == jnv == 2
        assert hb.image.shape == (2, 96, 96, 3) and hb.image.dtype == np.uint8
        _hostbatch_equal(hb, jhb)
    gb, nv = next(iter(NativeImagePipeline(Config(**kw), [npz], mode="train", canvas=96, seed=7, device="cpu")))
    assert gb.images.shape == (2, 64, 64, 3) and gb.seg_mask.shape == (2, 128) and nv == 2
    assert torch.isfinite(gb.images).all()


def test_native_pipeline_reports_decode_errors(tmp_path):
    """A shard holding bytes that are no JPEG: the consumer gets the
    decoder's error, naming the example."""
    from human_pose_estimation_tpu_torch.data.native_pipeline import NativeImagePipeline

    path = str(tmp_path / "bad.npz")
    tnpz.write_npz_shard(path, [b"notajpeg"], [b"notapng"], np.zeros((1, 3, 14), np.float32), np.zeros((1, 2)))
    pipe = NativeImagePipeline(Config(batch_size=1, img_size=64), [path], mode="val", canvas=64, device="cpu")
    with pytest.raises(ValueError, match=r"examples \[0\]"):
        next(iter(pipe))


def test_native_window_crop_matches_npz_and_jax(tmp_path):
    """A small person in a large frame (seed 5, 500x700): the source-
    resolution window crop cuts in both host paths; the native one equals
    the npz one within one uint8 step, keypoints within 1e-5 and the
    silhouette size exactly, and the JAX native one within 1e-5."""
    cv2 = pytest.importorskip("cv2")
    from human_pose_estimation_tpu.data.native_pipeline import NativeImagePipeline as JNative
    from human_pose_estimation_tpu_torch.data.native_pipeline import NativeImagePipeline

    rng = np.random.RandomState(5)
    h, w = 500, 700
    img = _smooth_image(rng, h, w)
    seg = np.zeros((h, w), np.uint8)
    seg[230:280, 490:545] = 255
    label = np.stack([520 + rng.rand(14) * 30 - 15, 255 + rng.rand(14) * 30 - 15, np.ones(14)]).astype(np.float32)
    npz = str(tmp_path / "shard.npz")
    tnpz.write_npz_shard(
        npz,
        [cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1].tobytes()],
        [cv2.imencode(".png", seg)[1].tobytes()],
        label[None],
        np.asarray([[520, 255]]),
    )
    kw = dict(batch_size=1, img_size=64, max_silhouette_points=4096)
    a, na = next(iter(NativeImagePipeline(Config(**kw), [npz], mode="val", canvas=96, device="cpu")))
    b, nb = next(iter(tnpz.NpzImagePipeline(Config(**kw), [npz], mode="val", canvas=96, device="cpu")))
    assert na == nb == 1
    assert (a.images - b.images).abs().max() <= 2.01 / 255
    np.testing.assert_allclose(a.kp2d.numpy(), b.kp2d.numpy(), rtol=0, atol=ATOL)
    assert float(a.seg_mask.sum()) == float(b.seg_mask.sum()) > 0
    ref, _ = next(iter(JNative(JConfig(**kw), [npz], mode="val", canvas=96)))
    _genbatch_close(a, ref)


# ---------------------------------------------------------------------------
# data/pipeline.py: the tf.data pipelines


@pytest.fixture(scope="module")
def image_record(tmp_path_factory):
    """Six random-size JPEG / PNG pairs (seed 0) in one image tfrecord,
    written by the JAX package's writer."""
    tf = pytest.importorskip("tensorflow")
    from human_pose_estimation_tpu.data import tfrecords as jtfrecords

    tmp = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    n = 6
    joints = np.zeros((3, 14, n), np.float32)
    pairs = []
    for i in range(n):
        h, w = int(rng.randint(40, 120)), int(rng.randint(40, 120))
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        seg = ((rng.rand(h, w, 1) > 0.5) * 255).astype(np.uint8)
        ip, sp = str(tmp / f"im{i:04d}.jpg"), str(tmp / f"im{i:04d}_segmentation.png")
        tf.io.write_file(ip, tf.io.encode_jpeg(img))
        tf.io.write_file(sp, tf.io.encode_png(seg))
        joints[0, :, i] = rng.rand(14) * (w - 1)
        joints[1, :, i] = rng.rand(14) * (h - 1)
        joints[2, :, i] = 1.0
        pairs.append((ip, sp))
    out = str(tmp / "lsp_16.tfrecords")
    assert jtfrecords.create_image_tfrecord(out, pairs, joints) == n
    return str(tmp), out, n


@pytest.mark.parametrize("cache", [False, True])
def test_image_pipeline_matches_jax(image_record, cache):
    """Mode 'val' over the same tfrecord, cached or not: the same batches
    and n_valid (batch 4: 4 + 2 padded); the valid rows' HostBatches
    element-equal to the JAX pipeline's, GenBatches within 1e-5 with
    silhouettes element-equal; the padded rows empty 1x1 examples, finite
    after the augmentation (the JAX pipeline's are NaN images); a cached
    pipeline gives the same stream on its second pass."""
    from human_pose_estimation_tpu.data.pipeline import ImagePipeline as JImagePipeline
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline

    data_dir, path, n = image_record
    kw = dict(data_dir=data_dir, batch_size=4, img_size=64, max_silhouette_points=256)
    common = dict(files=[path], mode="val", augment=False, canvas=128, cache=cache)
    pipe = ImagePipeline(Config(**kw), device="cpu", **common)
    ref = list(JImagePipeline(JConfig(**kw), **common))
    for _pass in range(2 if cache else 1):
        got = list(pipe)
        assert [nv for _, nv in got] == [nv for _, nv in ref] == [4, 2]
        for (b, nv), (rb, _) in zip(got, ref):
            _genbatch_close(b, rb, n=nv)
            assert torch.isfinite(b.images).all() and torch.isfinite(b.kp2d).all()
    host = list(ImagePipeline(Config(**kw), device_preprocess=False, **common))
    jhost = list(JImagePipeline(JConfig(**kw), device_preprocess=False, **common))
    assert [nv for _, nv in host] == [nv for _, nv in jhost]
    for (h, nv), (jh, _) in zip(host, jhost):
        _hostbatch_equal(h, jh, n=nv)
    np.testing.assert_array_equal(host[-1][0].hw[2:], np.ones((2, 2), np.int32))
    assert host[-1][0].image[2:].max() == 0 and host[-1][0].label[2:].max() == 0


def test_image_pipeline_train_stream_matches_jax(image_record):
    """Mode 'train' (shuffle, repeat, augmentation): the host stream is the
    JAX pipeline's, element for element, over two epochs (tf.data's
    seeded shuffle); the augmented GenBatches come out in range."""
    from human_pose_estimation_tpu.data.pipeline import ImagePipeline as JImagePipeline
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline

    data_dir, path, n = image_record
    kw = dict(data_dir=data_dir, batch_size=2, img_size=64, max_silhouette_points=256)
    it = iter(ImagePipeline(Config(**kw), files=[path], canvas=128, device_preprocess=False))
    jit = iter(JImagePipeline(JConfig(**kw), files=[path], canvas=128, device_preprocess=False))
    for _ in range(n):  # two epochs of batches
        (h, nv), (jh, jnv) = next(it), next(jit)
        assert nv == jnv == 2
        _hostbatch_equal(h, jh)
    gen = iter(ImagePipeline(Config(**kw), files=[path], canvas=128, device="cpu"))
    for _ in range(4):
        b, nv = next(gen)
        assert nv == 2 and b.images.shape == (2, 64, 64, 3) and b.seg_mask.shape == (2, 256)
        assert b.images.min() >= -1.0 - 1e-6 and b.images.max() <= 1.0 + 1e-6


def test_large_image_keeps_source_resolution(tmp_path):
    """A 1-pixel checkerboard person (3200 pixels) in an 800x600 frame:
    the window is cut at source resolution before the canvas fit, so the
    silhouette count is exact and the keypoints land within 0.6 px of
    the centre crop's; the GenBatch equals the JAX pipeline's within 1e-5."""
    tf = pytest.importorskip("tensorflow")
    from human_pose_estimation_tpu.data import tfrecords as jtfrecords
    from human_pose_estimation_tpu.data.pipeline import ImagePipeline as JImagePipeline
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline

    h, w = 600, 800
    rng = np.random.RandomState(0)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    cy, cx = 300, 480
    yy, xx = np.mgrid[0:h, 0:w]
    checker = ((yy + xx) % 2 == 0) & (np.abs(yy - cy) < 40) & (np.abs(xx - cx) < 40)
    seg = (checker * 255).astype(np.uint8)[..., None]
    joints = np.zeros((3, 14, 1), np.float32)
    joints[0, :, 0] = cx + np.linspace(-50, 50, 14)
    joints[1, :, 0] = cy + np.linspace(-60, 60, 14)
    joints[2, :, 0] = 1.0
    ip, sp = str(tmp_path / "im0000.jpg"), str(tmp_path / "im0000_segmentation.png")
    tf.io.write_file(ip, tf.io.encode_jpeg(img))
    tf.io.write_file(sp, tf.io.encode_png(seg))
    path = str(tmp_path / "big.tfrecords")
    assert jtfrecords.create_image_tfrecord(path, [(ip, sp)], joints) == 1

    kw = dict(data_dir=str(tmp_path), batch_size=1, img_size=224, max_silhouette_points=8192)
    batch, nv = next(iter(ImagePipeline(Config(**kw), files=[path], mode="val", augment=False, device="cpu")))
    assert nv == 1
    assert float(batch.seg_mask.sum()) == int(checker.sum())
    kp = batch.kp2d.numpy()[0]
    np.testing.assert_allclose((kp[:14, 0] + 1) * 0.5 * 224, joints[0, :, 0] - (cx - 112), atol=0.6)
    np.testing.assert_allclose((kp[:14, 1] + 1) * 0.5 * 224, joints[1, :, 0] - (cy - 112), atol=0.6)
    ref, _ = next(iter(JImagePipeline(JConfig(**kw), files=[path], mode="val", augment=False)))
    _genbatch_close(batch, ref)


def test_mocap_pipeline_matches_jax(tmp_path, tiny_model):
    """The mocap tfrecord stream (seed 1, 20 samples, batch 2 x 3 stages):
    raw (pose, shape) element-equal to the JAX stream with and without the
    shuffle, and the posed MocapBatch within 1e-5."""
    pytest.importorskip("tensorflow")
    from human_pose_estimation_tpu.data import tfrecords as jtfrecords
    from human_pose_estimation_tpu.data.pipeline import MocapPipeline as JMocapPipeline
    from human_pose_estimation_tpu_torch.data.pipeline import MocapPipeline

    rng = np.random.RandomState(1)
    poses = (rng.randn(20, 72) * 0.2).astype(np.float32)
    shapes = (rng.randn(20, 10) * 0.5).astype(np.float32)
    path = str(tmp_path / "neutrSMPL_CMU_01.tfrecord")
    assert jtfrecords.create_mocap_tfrecord(path, poses, shapes) == 20
    jcfg, cfg = JConfig(batch_size=2, num_stage=3), Config(batch_size=2, num_stage=3)
    smpl = synthetic_model(num_verts=120, seed=0)
    for shuffle in (False, True):
        it = iter(MocapPipeline(cfg, smpl, files=[path], shuffle=shuffle, device_forward=False, device="cpu"))
        jit = iter(JMocapPipeline(jcfg, tiny_model, files=[path], shuffle=shuffle, device_forward=False))
        for _ in range(5):  # past the end of the 20 samples: the stream repeats
            (p, s), (jp, js) = next(it), next(jit)
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    m = next(iter(MocapPipeline(cfg, smpl, files=[path], shuffle=False, device="cpu")))
    jm = next(iter(JMocapPipeline(jcfg, tiny_model, files=[path], shuffle=False)))
    assert m.joints.shape == (6, 19, 3) and m.rotations.shape == (6, 23, 3, 3)
    np.testing.assert_array_equal(m.shapes.numpy(), shapes[:6])
    for name in ("joints", "shapes", "rotations"):
        np.testing.assert_allclose(getattr(m, name).numpy(), np.asarray(getattr(jm, name)), rtol=0, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        MocapPipeline(cfg.replace(data_dir=str(tmp_path / "none")), smpl, device="cpu")


def test_factories_build_tfrecord_and_native(image_record, shard, tmp_path):
    """``make_image_pipeline`` / ``make_mocap_pipeline`` build the tf.data
    pipelines for ``tfrecord`` and the native pipeline (with the npz mocap
    stream) for ``native``; the first batch of each equals the pipeline
    built directly."""
    from human_pose_estimation_tpu_torch.data.native_pipeline import NativeImagePipeline
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline, MocapPipeline

    data_dir, record, n = image_record
    kw = dict(batch_size=2, img_size=64, max_silhouette_points=128)
    cfg = Config(input_pipeline="tfrecord", data_dir=data_dir, datasets=["lsp_16"], **kw)
    pipe = tdata.make_image_pipeline(cfg, mode="val", device="cpu")
    assert isinstance(pipe, ImagePipeline) and pipe.files == [record]
    b, nv = next(iter(pipe))
    rb, rnv = next(iter(ImagePipeline(cfg, files=[record], mode="val", device="cpu")))
    assert nv == rnv == 2 and torch.equal(b.images, rb.images)
    mocap_dir = tmp_path / "mocap_neutrMosh"
    mocap_dir.mkdir()
    from human_pose_estimation_tpu_torch.data import tfrecords

    rng = np.random.RandomState(3)
    tfrecords.create_mocap_tfrecord(
        str(mocap_dir / "neutrSMPL_CMU_0.tfrecord"), rng.randn(8, 72).astype(np.float32), rng.randn(8, 10).astype(np.float32)
    )
    mocap = tdata.make_mocap_pipeline(cfg.replace(data_dir=str(tmp_path), mocap_datasets=["CMU"]),
                                      synthetic_model(num_verts=30), device="cpu")
    assert isinstance(mocap, MocapPipeline)

    npz, _ = shard
    shutil.copy(npz, tmp_path / "lsp_train.npz")
    ncfg = Config(input_pipeline="native", data_dir=str(tmp_path), datasets=["lsp_train"], **kw)
    pipe = tdata.make_image_pipeline(ncfg, mode="val", device="cpu")
    assert isinstance(pipe, NativeImagePipeline)
    b, nv = next(iter(pipe))
    rb, _ = next(iter(NativeImagePipeline(ncfg, [npz], mode="val", device="cpu")))
    assert nv == 2 and torch.equal(b.images, rb.images)
    tnpz.write_mocap_npz_shard(str(mocap_dir / "neutrSMPL_CMU_0.npz"), np.zeros((6, 72)), np.zeros((6, 10)))
    npz_mocap = tdata.make_mocap_pipeline(ncfg.replace(mocap_datasets=["CMU"]), synthetic_model(num_verts=30), device="cpu")
    assert isinstance(npz_mocap, tnpz.NpzMocapPipeline) and npz_mocap.pose.shape == (6, 72)
    pytest.importorskip("grain")
    grain_pipe = tdata.make_image_pipeline(ncfg.replace(input_pipeline="grain"), mode="val", device="cpu")
    assert type(grain_pipe).__name__ == "GrainImagePipeline"
    b, nv = next(iter(grain_pipe))  # the same shard and order, decoded by OpenCV in grain's map
    assert nv == 2
    torch.testing.assert_close(b.images, rb.images, rtol=0, atol=ATOL)
    assert torch.equal(b.seg_mask, rb.seg_mask)
