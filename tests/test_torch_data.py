"""The port's on-device input path against the JAX package, on the CPU at a
small size (canvases of 96-128 px, crops of 64 px): ``augment_batch`` with
pinned draws, ``extract_silhouette``, ``DevicePreprocessor``, the npz image
and mocap streams and the pipeline factories.

Tolerances: crops, seg crops and labels within atol 1e-5 (both sides
resample in f32 with the same integer geometry; the products are summed in
another order); silhouette points and masks array-equal, which holds their
order too, so that truncation keeps the same pixels; mocap batches within
1e-5 (the body model in f32).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.data import augment as jaugment
from human_pose_estimation_tpu.data import npz_dataset as jnpz
from human_pose_estimation_tpu.data.pipeline import DevicePreprocessor as JDevicePreprocessor
from human_pose_estimation_tpu_torch import data as tdata
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.data import augment as taugment
from human_pose_estimation_tpu_torch.data import npz_dataset as tnpz
from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor, to_device
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

OUT = 64
ATOL = 1e-5


def _example(rng, h, w, canvas, center=None):
    """One canvas: random RGB inside (h, w), a seg of a filled ellipse plus
    noise, 19 keypoints inside, as uint8 / f32 / int32 numpy arrays."""
    img = np.zeros((canvas, canvas, 3), np.uint8)
    img[:h, :w] = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    blob = ((yy - h / 2) / (0.35 * h)) ** 2 + ((xx - w / 2) / (0.2 * w)) ** 2 < 1.0
    seg = np.zeros((canvas, canvas, 1), np.uint8)
    seg[:h, :w, 0] = (blob | (rng.rand(h, w) > 0.97)).astype(np.uint8) * 255
    kp = np.zeros((3, 19), np.float32)
    kp[0] = rng.rand(19) * (w - 1)
    kp[1] = rng.rand(19) * (h - 1)
    kp[2] = (rng.rand(19) > 0.3).astype(np.float32)
    c = np.asarray([w // 2, h // 2] if center is None else center, np.int32)
    return img, seg, kp, c, (h, w)


def _stack(examples):
    img, seg, kp, c, hw = zip(*examples)
    return dict(
        image=np.stack(img), seg=np.stack(seg), label=np.stack(kp), center=np.stack(c),
        hw=np.asarray(hw, np.int32),
    )


def _jax_augment(b, cfg, overrides=None):
    out = jaugment.augment_batch(
        jnp.asarray(b["image"]), jnp.asarray(b["seg"]), jnp.asarray(b["hw"]), jnp.asarray(b["center"]),
        jnp.asarray(b["label"]), None, jaugment.AugmentConfig(*cfg),
        overrides=None if overrides is None else tuple(jnp.asarray(o) for o in overrides),
    )
    return [np.asarray(o) for o in out]


def _torch_augment(b, cfg, overrides=None, generator=None):
    out = taugment.augment_batch(
        *(torch.from_numpy(b[k]) for k in ("image", "seg", "hw", "center", "label")),
        generator, taugment.AugmentConfig(*cfg),
        overrides=None if overrides is None else tuple(torch.from_numpy(np.asarray(o)) for o in overrides),
    )
    assert all(o.is_contiguous() for o in out)  # row-major, as the JAX arrays
    return [o.numpy() for o in out]


def _assert_augment_equal(out, ref):
    for name, a, r in zip(("crops", "seg crops", "labels"), out, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, rtol=0, atol=ATOL, err_msg=name)
    # the silhouettes of the two seg crops: the same pixels in the same order
    for a, r in zip(taugment.extract_silhouette(torch.from_numpy(out[1]), 300),
                    jaugment.extract_silhouette(jnp.asarray(ref[1]), 300)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("trans", [(0, 0), (9, -7)])
@pytest.mark.parametrize("scale", [1.0, 0.83, 1.19])
def test_augment_batch_matches_jax(scale, trans, flip, dtype):
    rng = np.random.RandomState(0)
    b = _stack([_example(rng, 57, 63, 112)])
    if dtype == "float":  # float inputs in [0, 1]
        b["image"] = b["image"].astype(np.float32) / 255.0
        b["seg"] = b["seg"].astype(np.float32) / 255.0
    overrides = (np.asarray([trans], np.int32), np.asarray([scale], np.float32), np.asarray([flip]))
    cfg = (OUT, 20, 0.8, 1.23, True)
    _assert_augment_equal(_torch_augment(b, cfg, overrides), _jax_augment(b, cfg, overrides))


def test_augment_batch_mixed_batch_matches_jax():
    """Three canvases of different extents, scales and flips; the first's
    jittered centre is negative (truncation toward zero, not floor)."""
    rng = np.random.RandomState(1)
    b = _stack([
        _example(rng, 90, 70, 128, center=(3, 5)),
        _example(rng, 128, 101, 128),
        _example(rng, 61, 128, 128, center=(80, 20)),
    ])
    overrides = (
        np.asarray([[-9, -7], [13, 4], [-20, 19]], np.int32),
        np.asarray([1.19, 0.8, 1.23], np.float32),
        np.asarray([True, False, True]),
    )
    cfg = (OUT, 20, 0.8, 1.23, True)
    out, ref = _torch_augment(b, cfg, overrides), _jax_augment(b, cfg, overrides)
    _assert_augment_equal(out, ref)
    assert (out[1][0] > 0).any() and (out[2][..., 2].sum(axis=1) > 0).all()


def test_augment_false_is_the_jax_centre_crop():
    rng = np.random.RandomState(2)  # the mixed batch's shapes: JAX reuses its compiled ops
    b = _stack([_example(rng, 80, 96, 128), _example(rng, 128, 60, 128), _example(rng, 100, 128, 128)])
    cfg = (OUT, 20, 0.8, 1.23, False)
    _assert_augment_equal(_torch_augment(b, cfg), _jax_augment(b, cfg))


def test_augment_draws_in_range_and_repeatable():
    cfg = taugment.AugmentConfig(out_size=OUT, trans_max=5, scale_min=0.8, scale_max=1.23)
    trans, scales, flips = taugment._draws(256, cfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    assert trans.dtype == torch.int32 and int(trans.min()) == -5 and int(trans.max()) == 4  # [min, max)
    assert float(scales.min()) >= 0.8 and float(scales.max()) <= 1.23 and float(scales.std()) > 0.05
    assert flips.any() and (~flips).any()
    again = taugment._draws(256, cfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    for a, b in zip((trans, scales, flips), again):
        assert torch.equal(a, b)
    # through augment_batch: the same seed gives the same crops, another seed others
    rng = np.random.RandomState(4)
    b = _stack([_example(rng, 70, 80, 96) for _ in range(4)])
    run = lambda seed: _torch_augment(b, tuple(cfg), generator=torch.Generator().manual_seed(seed))
    first, same, other = run(5), run(5), run(6)
    for a, s in zip(first, same):
        np.testing.assert_array_equal(a, s)
    assert not np.array_equal(first[0], other[0])
    with pytest.raises(ValueError, match="Generator"):
        _torch_augment(b, tuple(cfg))


def _sil_pair(segs, max_points, threshold=0.0):
    out = taugment.extract_silhouette(torch.from_numpy(segs), max_points, threshold)
    ref = jaugment.extract_silhouette(jnp.asarray(segs), max_points, threshold)
    for a, r in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    return [a.numpy() for a in out]


def test_extract_silhouette_packed_and_truncated_matches_jax():
    seg = np.zeros((2, 16, 16, 1), np.float32)
    seg[0, 3, 5] = 1.0
    seg[0, 10, 2] = 1.0
    seg[1] = 1.0  # over the cap: truncation keeps the first 8 of the order
    pts, mask = _sil_pair(seg, max_points=8)
    assert mask[0].sum() == 2 and mask[1].sum() == 8
    assert pts[1][:, 1].max() - pts[1][:, 1].min() > 4  # interleaved rows


@pytest.mark.parametrize("h,w", [(16, 16), (256, 256), (272, 260)])
def test_extract_silhouette_matches_jax(h, w):
    """The packed sort (16x16), its exact boundary (256x256 = 2^16) and the
    fallback (272x260): a sparse mask under the cap, a dense blob over it,
    an empty mask."""
    rng = np.random.RandomState(5)
    segs = np.zeros((3, h, w, 1), np.float32)
    segs[0, ..., 0] = (rng.rand(h, w) > 0.99).astype(np.float32)
    segs[1, h // 4 : 3 * h // 4, w // 4 : 3 * w // 4, 0] = 1.0
    pts, mask = _sil_pair(segs, max_points=64)
    assert mask[1].sum() == 64 and mask[2].sum() == 0 and (pts[2] == 0).all()


def test_extract_silhouette_threshold_matches_jax():
    seg = np.zeros((1, 16, 16, 1), np.float32)
    seg[0, 2, 3] = 0.4
    seg[0, 5, 6] = 0.9
    pts, mask = _sil_pair(seg, max_points=4, threshold=0.5)
    assert mask[0].sum() == 1 and tuple(pts[0][0].astype(int)) == (6, 5)


def test_device_preprocessor_matches_jax():
    """augment=False (no draws): the GenBatch of the port's
    DevicePreprocessor against the JAX one's, from numpy and from tensors."""
    rng = np.random.RandomState(6)
    b = _stack([_example(rng, 90, 80, 96), _example(rng, 70, 96, 96), _example(rng, 96, 96, 96)])
    kw = dict(img_size=OUT, batch_size=3, max_silhouette_points=600)
    ref = JDevicePreprocessor(JConfig(**kw), augment=False)(b, None)
    prep = DevicePreprocessor(Config(**kw), augment=False, device="cpu")
    for host in (b, {k: torch.from_numpy(v) for k, v in b.items()}):
        out = prep(host)
        for name in ("images", "kp2d"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), rtol=0, atol=ATOL)
        for name in ("seg_points", "seg_mask"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)))
    assert out.seg_mask.sum(dim=1).min() > 100


def test_to_device_keeps_host_tensors():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = to_device(a, torch.device("cpu"))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.tolist() == a.tolist()
    assert to_device(t, torch.device("cpu")) is t


@pytest.fixture(scope="module")
def mocap_shard(tmp_path_factory):
    rng = np.random.RandomState(7)
    path = str(tmp_path_factory.mktemp("mocap") / "neutrSMPL_CMU_00.npz")
    pose = (rng.randn(20, 72) * 0.3).astype(np.float32)
    shape = (rng.randn(20, 10) * 0.5).astype(np.float32)
    assert tnpz.write_mocap_npz_shard(path, pose, shape) == 20
    return path


def test_npz_mocap_pipeline_matches_jax(mocap_shard, tiny_model):
    """The same (pose, shape) batches per seed and epoch (batch 2 x 3
    stages = 6 of 20 samples: 3 per epoch, the remainder dropped), the
    same stream after get_state / set_state, and device_forward's
    MocapBatch within 1e-5."""
    jcfg, cfg = JConfig(batch_size=2, seed=3), Config(batch_size=2, seed=3)
    smpl = synthetic_model(num_verts=120, seed=0)
    ref = iter(jnpz.NpzMocapPipeline(jcfg, tiny_model, [mocap_shard], device_forward=False))
    pipe = tnpz.NpzMocapPipeline(cfg, smpl, [mocap_shard], device_forward=False, device="cpu")
    it = iter(pipe)
    for _ in range(7):  # over two epoch boundaries
        (p, s), (jp, js) = next(it), next(ref)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    state = pipe.get_state()
    assert state == {"epoch": 2, "pos": 6}
    rest = [next(it) for _ in range(4)]
    resumed = tnpz.NpzMocapPipeline(cfg, smpl, [mocap_shard], device_forward=False, device="cpu")
    resumed.set_state(state)
    for (p, s), (rp, rs) in zip(rest, iter(resumed)):
        assert torch.equal(p, rp) and torch.equal(s, rs)

    jfwd = next(iter(jnpz.NpzMocapPipeline(jcfg, tiny_model, [mocap_shard])))
    fwd = next(iter(tnpz.NpzMocapPipeline(cfg, smpl, [mocap_shard], device="cpu")))
    assert fwd.rotations.shape == (6, 23, 3, 3) and fwd.joints.shape == (6, 19, 3)
    for name in ("joints", "shapes", "rotations"):
        np.testing.assert_allclose(getattr(fwd, name).numpy(), np.asarray(getattr(jfwd, name)), rtol=0, atol=1e-5)


def test_write_mocap_shard_checks_shapes(tmp_path):
    with pytest.raises(ValueError):
        tnpz.write_mocap_npz_shard(str(tmp_path / "x.npz"), np.zeros((4, 71)), np.zeros((4, 10)))
    with pytest.raises(ValueError):
        tnpz.write_mocap_npz_shard(str(tmp_path / "x.npz"), np.zeros((4, 72)), np.zeros((3, 10)))


@pytest.fixture(scope="module")
def image_shard(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(8)
    jpegs, pngs, labels, centers = [], [], [], []
    for i in range(5):
        h, w = 150 + 9 * i, 120 + 7 * i  # larger than the person window: pre-crop and resize
        img, seg, kp, c, _ = _example(rng, h, w, max(h, w))
        jpegs.append(cv2.imencode(".jpg", cv2.cvtColor(img[:h, :w], cv2.COLOR_RGB2BGR))[1].tobytes())
        pngs.append(cv2.imencode(".png", seg[:h, :w, 0])[1].tobytes())
        labels.append(kp[:, :14])
        centers.append(c)
    path = str(tmp_path_factory.mktemp("images") / "lsp_5.npz")
    assert tnpz.write_npz_shard(path, jpegs, pngs, np.stack(labels), np.stack(centers)) == 5
    return path


def test_npz_image_pipeline_matches_jax(image_shard):
    """Mode 'val' (no shuffle, no augmentation, one pass, the last batch
    padded): the same batches and n_valid, GenBatch within 1e-5."""
    kw = dict(batch_size=2, img_size=OUT, max_silhouette_points=512)
    ref = list(jnpz.NpzImagePipeline(JConfig(**kw), [image_shard], mode="val", canvas=96))
    out = list(tnpz.NpzImagePipeline(Config(**kw), [image_shard], mode="val", canvas=96, device="cpu"))
    assert [n for _, n in out] == [n for _, n in ref] == [2, 2, 1]
    for (b, _), (rb, _) in zip(out, ref):
        for name in ("images", "kp2d"):
            np.testing.assert_allclose(getattr(b, name).numpy(), np.asarray(getattr(rb, name)), rtol=0, atol=ATOL)
        for name in ("seg_points", "seg_mask"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(rb, name)))
    assert float(out[0][0].seg_mask.sum()) > 0


def test_pipeline_factories_take_npz_and_refuse_the_rest(tmp_path, mocap_shard, image_shard):
    data_dir = os.path.dirname(image_shard)
    cfg = Config(input_pipeline="npz", data_dir=data_dir, batch_size=2, img_size=OUT, max_silhouette_points=64)
    pipe = tdata.make_image_pipeline(cfg, datasets=["lsp_5"], mode="val", device="cpu")
    assert isinstance(pipe, tnpz.NpzImagePipeline) and pipe.batch_size == 2
    assert tdata.npz_shard_files(data_dir, ["lsp_5", "other"]) == [image_shard, os.path.join(data_dir, "other.npz")]
    mocap_dir = tmp_path / "mocap_neutrMosh"
    mocap_dir.mkdir()
    (mocap_dir / os.path.basename(mocap_shard)).write_bytes(open(mocap_shard, "rb").read())
    mcfg = cfg.replace(data_dir=str(tmp_path), mocap_datasets=["CMU"])
    assert tdata.npz_mocap_files(str(tmp_path), ["CMU", "jointLim"]) == [str(mocap_dir / os.path.basename(mocap_shard))]
    mocap = tdata.make_mocap_pipeline(mcfg, synthetic_model(num_verts=30), device="cpu")
    assert isinstance(mocap, tnpz.NpzMocapPipeline) and mocap.pose.shape == (20, 72)
    # tfrecord and native are ported (tests/test_torch_native.py), and grain
    # (tests/test_torch_parallel.py): its images from GrainImagePipeline over
    # the same shard, its mocap from the npz shards
    native = tdata.make_image_pipeline(cfg.replace(input_pipeline="native"), datasets=["lsp_5"], mode="val", device="cpu")
    assert type(native).__name__ == "NativeImagePipeline" and native.batch_size == 2
    assert isinstance(
        tdata.make_mocap_pipeline(mcfg.replace(input_pipeline="native"), synthetic_model(num_verts=30), device="cpu"),
        tnpz.NpzMocapPipeline,
    )
    pytest.importorskip("grain")
    from human_pose_estimation_tpu_torch.data.grain_pipeline import GrainImagePipeline

    other = cfg.replace(input_pipeline="grain")
    grain_pipe = tdata.make_image_pipeline(other, datasets=["lsp_5"], mode="val", device="cpu")
    assert isinstance(grain_pipe, GrainImagePipeline) and grain_pipe.batch_size == 2
    assert [n for _, n in grain_pipe] == [n for _, n in pipe] == [2, 2, 1]
    assert isinstance(
        tdata.make_mocap_pipeline(mcfg.replace(input_pipeline="grain"), synthetic_model(num_verts=30), device="cpu"),
        tnpz.NpzMocapPipeline,
    )
