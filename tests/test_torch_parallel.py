"""The port's data parallelism and the host paths that feed it, on the CPU.

* Two gloo ranks against one process (worker ``tests/torch_dp_worker.py``,
  a fresh interpreter per rank that imports torch and the port only): the
  fused training step in f64 (augmentation, dropout and penalty uniforms
  drawn for the global batch), and a ``Trainer`` over 2 steps with a
  checkpoint written by rank 0, restored on both ranks, and a
  ``validate_checkpoint`` sweep of global means. The training step itself
  is held in ``tests/test_torch_train.py::test_two_rank_train_step``.
* ``make_mesh``'s gcd trimming and the row layout of the ranks.
* ``Predictor(data_parallel=True)`` over two CPU device entries against the
  plain predictor (atol 1e-5; the JAX test holds 1e-4).
* Per-rank example sharding of the tf.data ``ImagePipeline`` and of the
  ``GrainImagePipeline`` (after ``tests/test_multihost.py``): disjoint,
  covering, equal counts; the grain pipeline's host batches equal to the
  JAX one's and its resumable position; the factory's refusals.
* The npz converters, whose shards hold the JAX package's bytes.

Ranks are simulated in one process (``parallel.mesh.rank`` /
``world_size`` patched) where only the rank's slice of the input is at
stake; every spawned rank has a timeout of its own
(``torch_dp_worker.TIMEOUT``).
"""
import os
import zipfile

import numpy as np
import pytest
import torch

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.data import npz_dataset as jnpz
from human_pose_estimation_tpu.data import tfrecords as jtfrecords
from human_pose_estimation_tpu_torch import data as tdata
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.data import npz_dataset as tnpz
from human_pose_estimation_tpu_torch.data import tfrecords as ttfrecords
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.parallel import mesh as pmesh
from human_pose_estimation_tpu_torch.train.step import HostBatch
from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

import torch_dp_worker as dp_worker  # tests/torch_dp_worker.py: the 2-rank gloo worker

IMG, CANVAS, BATCH, NSIL = 56, 80, 8, 256
STAGES = "1,1,1,1"


def _cfg(**kw):
    base = dict(img_size=IMG, batch_size=BATCH, encoder_stage_sizes=STAGES, encoder_dtype="float32",
                use_mesh_repro_loss=True, max_silhouette_points=NSIL, trans_max=8)
    base.update(kw)
    return base


def _ranks(monkeypatch, rank, world=2):
    monkeypatch.setattr(pmesh, "rank", lambda: rank)
    monkeypatch.setattr(pmesh, "world_size", lambda: world)


# ---------------------------------------------------------------------------
# two ranks against one process


def _host_batch(rng, n=BATCH) -> HostBatch:
    """uint8 canvases with an elliptic silhouette, 19 keypoints, extents and
    centres."""
    image = np.zeros((n, CANVAS, CANVAS, 3), np.uint8)
    seg = np.zeros((n, CANVAS, CANVAS, 1), np.uint8)
    hw = rng.randint(60, CANVAS + 1, (n, 2)).astype(np.int32)
    center = np.zeros((n, 2), np.int32)
    label = np.zeros((n, 3, 19), np.float32)
    for b, (h, w) in enumerate(hw):
        image[b, :h, :w] = rng.randint(0, 256, (h, w, 3))
        cx, cy = w // 2 + rng.randint(-4, 5), h // 2 + rng.randint(-4, 5)
        yy, xx = np.mgrid[:h, :w]
        seg[b, :h, :w, 0] = 255 * ((((yy - cy) / 20.0) ** 2 + ((xx - cx) / 9.0) ** 2) < 1.0)
        center[b] = cx, cy
        label[b, 0] = cx + rng.randn(19) * 6
        label[b, 1] = cy + rng.randn(19) * 12
        label[b, 2] = rng.rand(19) > 0.2
    return HostBatch(image, seg, hw, center, label)


def _assert_f64_close(got, ref, what):
    """f64 results at 1e-9 of each tensor's largest magnitude (floor: 1e-5
    of the largest of all: the conv biases before a BN hold only rounding
    of an exact zero gradient), ``mr_losses`` at 1e-6 (the chamfer
    computes in f32 on every path)."""
    for name, v in ref["metrics"].items():
        rtol = 1e-6 if name == "mr_losses" else 1e-9
        np.testing.assert_allclose(got["metrics"][name], v, rtol=rtol, atol=rtol * float(np.abs(v).max()),
                                   err_msg=f"{what} {name}")
    big = max(float(np.abs(v).max()) for v in ref["state"].values())
    for k, v in ref["state"].items():
        tol = 1e-9 * max(float(np.abs(v).max()), 1e-5 * big)
        err = float(np.abs(got["state"][k] - v).max())
        assert err <= tol, (what, k, err, tol)


def test_fused_step_two_ranks_match_one_process(tmp_path):
    """``make_fused_train_step`` in f64 on 2 ranks (4 canvases and 12 mocap
    samples each) against one process over the 8 and 24: the augmentation,
    the last stage's dropout and the penalty's uniforms are drawn for the
    global batch from one generator seed, so the step is the same one. The
    ranks end bit-equal."""
    rng = np.random.RandomState(0)
    host = _host_batch(rng)
    raw = ((rng.randn(3 * BATCH, 72) * 0.2).astype(np.float32), (rng.randn(3 * BATCH, 10) * 0.4).astype(np.float32))
    case = dict(cfg=_cfg(), dtype=torch.float64, host=tuple(host), raw=raw)
    ranks = dp_worker.spawn(
        {"kind": "fused", "cases": {"fused": dict(case, cfg=_cfg(batch_size=BATCH // 2))}}, str(tmp_path)
    )
    one = dp_worker.run_fused(case)
    for part in ("metrics", "state"):
        for k, v in ranks[0]["fused"][part].items():
            np.testing.assert_array_equal(ranks[1]["fused"][part][k], v, err_msg=k)
    _assert_f64_close(ranks[0]["fused"], one, "fused")
    assert float(one["metrics"]["critic_penalty"]) > 0 and (one["metrics"]["mr_losses"] > 0).all()


def _gen_arrays(rng, n):
    images = (rng.rand(n, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    counts = rng.randint(20, NSIL + 1, size=n)
    seg_mask = (np.arange(NSIL)[None] < counts[:, None]).astype(np.float32)
    seg_points = rng.randint(0, IMG, size=(n, NSIL, 2)).astype(np.float32) * seg_mask[..., None]
    kp2d = (rng.rand(n, 19, 3) * 2 - 1).astype(np.float32)
    kp2d[..., 2] = (rng.rand(n, 19) > 0.2).astype(np.float32)
    return images, seg_points, seg_mask, kp2d


def _mocap_arrays(rng, m):
    from human_pose_estimation_tpu_torch.core.smpl import smpl_forward

    pose = torch.from_numpy((rng.randn(m, 72) * 0.2).astype(np.float32))
    shape = torch.from_numpy((rng.randn(m, 10) * 0.4).astype(np.float32))
    out = smpl_forward(synthetic_model(num_verts=120, seed=0), shape, pose, joint_type="cocoplus")
    return out.joints.numpy(), shape.numpy(), out.rotations[:, 1:].numpy()


def test_two_rank_trainer_checkpoint_and_restore(tmp_path):
    """A ``Trainer`` on 2 ranks (batch 4 each, an epoch of 2 steps over 16
    examples, validation at step 2, a checkpoint at the epoch's end): the
    ranks log the same global values and end bit-equal; rank 0 alone wrote
    the one step directory, with its input position; a fresh ``Trainer``
    on each rank restores it bit for bit; and ``validate_checkpoint``'s
    global means equal a one-process sweep of the same checkpoint over the
    8-row batches (rtol 1e-5). The first step's metrics (before any update)
    equal a one-process Trainer's over the global batches (rtol 1e-5)."""
    from human_pose_estimation_tpu_torch.train.step import GenBatch, MocapBatch
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(1)
    steps, half = 2, BATCH // 2
    train = [_gen_arrays(rng, BATCH) for _ in range(steps)]
    val = [_gen_arrays(rng, BATCH) for _ in range(2)]
    mocap = [_mocap_arrays(rng, 3 * half) for _ in range(steps)]  # every rank reads the same stream
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = _cfg(batch_size=half, epoch=1, checkpoint_every_epochs=1, checkpoint_dir=ckpt_dir,
               num_examples_override=steps * BATCH, validation_step_size=steps, log_img_step=0, seed=5)
    ranks = dp_worker.spawn({"kind": "trainer", "cfg": cfg, "train": train, "mocap": mocap, "val": val},
                            str(tmp_path / "spawn"))
    r0, r1 = ranks
    assert r0["itr_per_epoch"] == r1["itr_per_epoch"] == 2.0  # 16 examples / (4 x 2 ranks)
    assert r0["history"] == r1["history"] and len(r0["history"]["kpr"]) == steps
    assert r0["val_history"] == r1["val_history"] and [s for _, s, _ in r0["val_history"]] == [steps, steps]
    for k, v in r0["trained"].items():
        np.testing.assert_array_equal(r1["trained"][k], v, err_msg=k)
        np.testing.assert_array_equal(r0["restored"][k], v, err_msg=k)
        np.testing.assert_array_equal(r1["restored"][k], v, err_msg=k)
    assert r0["restored_step"] == r1["restored_step"] == steps
    assert sorted(os.listdir(ckpt_dir)) == [str(steps)]
    assert sorted(os.listdir(os.path.join(ckpt_dir, str(steps)))) == ["input_state.json", "train_state.pt"]
    assert r0["input_pos"] == r1["input_pos"] == steps

    # one process: the sweep of the same checkpoint over the global batches
    smpl = synthetic_model(num_verts=120, seed=0)
    one_cfg = Config(**dict(cfg, batch_size=BATCH))
    val_one = [(GenBatch(*map(torch.from_numpy, b)), BATCH) for b in val]
    ref = Trainer(one_cfg, val_dataset=val_one, smpl=smpl, device="cpu").validate_checkpoint()
    for key, v in ref.items():
        np.testing.assert_allclose(r0["validate"][key], v, rtol=1e-5, err_msg=key)
        assert r1["validate"][key] == r0["validate"][key], key

    # one process over the global batches: the first step's metrics; the
    # global mocap batch is the ranks' blocks in their places (row_index)
    glob = np.zeros((3 * BATCH,), np.int64)
    for r in range(2):
        glob[pmesh.row_index(3 * half, 3, r, 2).numpy()] = np.arange(3 * half)
    one = Trainer(Config(**dict(cfg, batch_size=BATCH, checkpoint_dir=str(tmp_path / "one"))),
                  dataset=[(GenBatch(*map(torch.from_numpy, train[0])), BATCH)],
                  mocap_dataset=[MocapBatch(*(torch.from_numpy(a[glob]) for a in mocap[0]))],
                  smpl=smpl, device="cpu")
    hist = one.train(max_steps=1)
    for key in ("kpr", "mr", "gen_critic", "critic"):
        np.testing.assert_allclose(r0["history"][key][0], hist[key][0], rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# mesh helpers and data-parallel serving


def test_make_mesh_trims_to_the_gcd_and_the_rank_layout(monkeypatch):
    eight = ["cpu"] * 8
    assert len(pmesh.make_mesh(eight)) == 8
    assert [len(pmesh.make_mesh(eight, batch_size=b)) for b in (4, 6, 7, 16, 64)] == [4, 2, 1, 8, 8]
    assert pmesh.make_mesh(["cpu", "cpu"], batch_size=3) == [torch.device("cpu")]
    assert pmesh.pad_to_multiple(5, 4) == 8 and pmesh.pad_to_multiple(8, 4) == 8
    # the critic's fakes are 3 stage blocks: rank 1 of 2 holds rows 4-7 of each
    assert pmesh.row_index(12, 3, 1, 2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]
    assert pmesh.row_index(4, 1, 0, 2).tolist() == [0, 1, 2, 3]
    # no process group: every helper is the identity
    assert (pmesh.rank(), pmesh.world_size(), pmesh.is_distributed()) == (0, 1, False)
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.local_rows(x, 3) is x and pmesh.global_sum(x) is x
    assert pmesh.all_gather_rows(x) is x and pmesh.broadcast_object("cfg") == "cfg"
    assert torch.equal(pmesh.mean_share(x, 0), x.mean(dim=0)) and not pmesh.maybe_initialize_distributed("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()


@pytest.mark.parametrize(
    "world,local,batch,examples",
    [(1, None, 4, 16), (2, None, 4, 16), (2, 1, 4, 16), (4, 2, 4, 16), (8, 4, 2, 100), (4, 1, 8, 7)],
)
def test_epoch_count_is_the_jax_hosts(monkeypatch, world, local, batch, examples):
    """A JAX host is a torchrun node: the port's steps per epoch equal the
    JAX trainer's ``num_images / batch_size`` (JAX train/trainer.py:137)
    with its per-host batch = the per-rank batch x LOCAL_WORLD_SIZE (unset:
    every rank on one node, the whole world)."""
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    _ranks(monkeypatch, 0, world)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    assert pmesh.local_world_size() == (world if local is None else local)
    cfg = Config(**_cfg(batch_size=batch, num_examples_override=examples, model_dir=None))
    trainer = Trainer(cfg, validation_only=True, smpl=synthetic_model(num_verts=120, seed=0), device="cpu")
    per_host_batch = batch * (world if local is None else local)
    assert trainer.num_itr_per_epoch == max(examples / per_host_batch, 1)


def local_devices(monkeypatch, n):
    """``make_mesh`` sees ``n`` CPU device entries as the local devices (its
    gcd trimming kept): a machine with several cards, simulated."""
    real = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda devices=None, batch_size=None: real(["cpu"] * n, batch_size))


def test_predictor_data_parallel_matches_plain(rng, monkeypatch):
    """``data_parallel=True`` over two CPU device entries: each replica
    serves its half of the padded batch; the outputs equal the plain
    predictor's within 1e-5 for a full and a partial batch."""
    cfg = Config(img_size=64, batch_size=8, encoder_dtype="float32", encoder_stage_sizes=STAGES)
    smpl = synthetic_model(num_verts=30)
    variables = HMR(smpl, encoder_stage_sizes=(1, 1, 1, 1), device="cpu", seed=4).state_dict()
    mean = synthetic_mean_params()[None]
    plain = Predictor(cfg, smpl=smpl, variables=variables, mean_theta=mean, device="cpu")
    assert len(Predictor(cfg, smpl=smpl, variables=variables, mean_theta=mean, device="cpu",
                         data_parallel=True).replicas) == 1  # the CPU is one device
    local_devices(monkeypatch, 2)
    dp = Predictor(cfg, smpl=smpl, variables=variables, mean_theta=mean, device="cpu", data_parallel=True)
    assert len(dp.replicas) == 2 and len(plain.replicas) == 1
    images = (rng.rand(8, 64, 64, 3) * 2 - 1).astype(np.float32)
    for n in (8, 5):
        got, ref = dp.predict(images[:n]), plain.predict(images[:n])
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].shape == v.shape and v.shape[0] == n
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    # a batch of 6 on 4 entries serves on gcd(6, 4) = 2
    local_devices(monkeypatch, 4)
    six = Predictor(cfg.replace(batch_size=6), smpl=smpl, variables=variables, mean_theta=mean, device="cpu",
                    data_parallel=True)
    assert len(six.replicas) == 2


# ---------------------------------------------------------------------------
# per-rank input sharding


def _write_examples(tmp, rng, n):
    """n JPEG / PNG example files and their (3, 14, n) joints."""
    cv2 = pytest.importorskip("cv2")
    pairs, joints = [], np.zeros((3, 14, n), np.float32)
    for i in range(n):
        h, w = 64 + (i % 3) * 4, 60 + (i % 2) * 6
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        seg = np.zeros((h, w), np.uint8)
        seg[16:48, 14:40] = 255
        ip, sp = str(tmp / f"im{i:04d}.jpg"), str(tmp / f"im{i:04d}_segmentation.png")
        cv2.imwrite(ip, img)
        cv2.imwrite(sp, seg)
        joints[0, :, i] = rng.rand(14) * (w - 1)
        joints[1, :, i] = rng.rand(14) * (h - 1)
        joints[2, :, i] = 1.0
        pairs.append((ip, sp))
    joints[2, :, 3] = 0.0  # no visible joint: the converters skip it
    return pairs, joints


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_examples")
    pairs, joints = _write_examples(tmp, np.random.RandomState(2), 13)
    return tmp, pairs, joints


def test_image_pipeline_shards_examples_by_rank(examples, monkeypatch):
    """Two tfrecord files of 2 and 10 examples, two ranks: each rank reads
    6 examples (the shard is over examples, not files), disjoint, together
    all 12."""
    tf = pytest.importorskip("tensorflow")
    from human_pose_estimation_tpu_torch.data.pipeline import ImagePipeline

    tmp, pairs, joints = examples
    keep = [i for i in range(len(pairs)) if i != 3]
    small, big = str(tmp / "small.tfrecords"), str(tmp / "big.tfrecords")
    assert ttfrecords.create_image_tfrecord(small, [pairs[i] for i in keep[:2]], joints[:, :, keep[:2]]) == 2
    assert ttfrecords.create_image_tfrecord(big, [pairs[i] for i in keep[2:]], joints[:, :, keep[2:]]) == 10
    cfg = Config(batch_size=2, img_size=48, max_silhouette_points=64)

    def ids(rank):
        _ranks(monkeypatch, rank)
        pipe = ImagePipeline(cfg, files=[small, big], mode="val", canvas=64, shard_by_host=True, device="cpu")
        return [round(float(b.images[i].abs().sum()), 3) for b, n in pipe for i in range(n)]

    a, b = ids(0), ids(1)
    assert len(a) == len(b) == 6
    assert not set(a) & set(b) and len(set(a) | set(b)) == 12
    del tf


@pytest.fixture(scope="module")
def npz_shard(examples):
    tmp, pairs, joints = examples
    path = str(tmp / "lsp_dp.npz")
    assert tnpz.convert_images_to_npz_shard(path, pairs, joints) == 12
    return path


def test_grain_pipeline_matches_jax_and_shards_by_rank(npz_shard, monkeypatch):
    """The grain pipeline in mode 'val' (no shuffle, no augmentation, one
    pass, the last batch padded): host batches equal to the JAX
    pipeline's; under 2 ranks, per-rank slices disjoint, covering and of
    equal counts, with equal positions after equal reads; and a position
    from ``get_state`` resumed by ``set_state`` on a fresh pipeline yields
    the same next batch (a shuffled, repeating, augmenting stream)."""
    pytest.importorskip("grain")
    from human_pose_estimation_tpu.data.grain_pipeline import GrainImagePipeline as JGrain
    from human_pose_estimation_tpu_torch.data.grain_pipeline import GrainImagePipeline

    kw = dict(batch_size=5, img_size=48, max_silhouette_points=64)
    ref = JGrain(JConfig(**kw), [npz_shard], mode="val", canvas=64)
    pipe = GrainImagePipeline(Config(**kw), [npz_shard], mode="val", canvas=64, device="cpu")
    ref_hosts, hosts = list(ref._it), list(pipe._it)
    assert [h["image"].shape[0] for h in hosts] == [h["image"].shape[0] for h in ref_hosts] == [5, 5, 2]
    for h, rh in zip(hosts, ref_hosts):
        assert set(h) == set(rh)
        for k in h:
            assert h[k].dtype == rh[k].dtype, k
            np.testing.assert_array_equal(h[k], rh[k], err_msg=k)
    out = list(GrainImagePipeline(Config(**kw), [npz_shard], mode="val", canvas=64, device="cpu"))
    assert [n for _, n in out] == [5, 5, 2] and out[-1][0].images.shape[0] == 5

    cfg = Config(batch_size=2, img_size=48, max_silhouette_points=64)
    rows, states = [], []
    for rank in (0, 1):
        _ranks(monkeypatch, rank)
        sharded = GrainImagePipeline(cfg, [npz_shard], mode="val", canvas=64, shard_by_host=True, device="cpu")
        it = iter(sharded)
        got = [next(it) for _ in range(2)]
        states.append(sharded.get_state())
        got += list(it)
        rows.append([tuple(b.kp2d[i].flatten().tolist()) for b, n in got for i in range(n)])
    assert len(rows[0]) == len(rows[1]) == 6
    assert not set(rows[0]) & set(rows[1]) and len(set(rows[0]) | set(rows[1])) == 12
    assert states[0] == states[1]  # one input_state.json serves every rank

    _ranks(monkeypatch, 0, world=1)
    train_kw = dict(mode="train", canvas=64, augment=True, device="cpu")
    a = GrainImagePipeline(cfg, [npz_shard], **train_kw)
    it = iter(a)
    for _ in range(3):
        next(it)
    state = a.get_state()
    assert state["step"] == 3
    want = next(it)[0]
    b = GrainImagePipeline(cfg, [npz_shard], **train_kw)
    b.set_state(state)
    got = next(iter(b))[0]
    for name in ("images", "seg_points", "seg_mask", "kp2d"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_factory_builds_grain_and_refuses_npz_and_native_across_ranks(npz_shard, monkeypatch):
    """``input_pipeline='grain'`` builds a ``GrainImagePipeline`` (its mocap
    stream the npz one); with ``shard_by_host`` under 2 ranks grain and
    tfrecord shard, npz and native raise ValueError, and without
    ``shard_by_host`` they build."""
    pytest.importorskip("grain")
    from human_pose_estimation_tpu_torch.data.grain_pipeline import GrainImagePipeline

    data_dir = os.path.dirname(npz_shard)
    cfg = Config(input_pipeline="grain", data_dir=data_dir, datasets=["lsp_dp"], batch_size=2, img_size=48,
                 max_silhouette_points=64)
    _ranks(monkeypatch, 1)
    pipe = tdata.make_image_pipeline(cfg, mode="train", shard_by_host=True, device_preprocess=False, device="cpu")
    assert isinstance(pipe, GrainImagePipeline) and pipe.batch_size == 2
    for name in ("npz", "native"):
        with pytest.raises(ValueError, match="cannot shard"):
            tdata.make_image_pipeline(cfg.replace(input_pipeline=name), shard_by_host=True, device="cpu")
        built = tdata.make_image_pipeline(cfg.replace(input_pipeline=name), mode="val", device="cpu")
        assert built.batch_size == 2
    mocap_dir = os.path.join(data_dir, "mocap_neutrMosh")
    os.makedirs(mocap_dir, exist_ok=True)
    tnpz.write_mocap_npz_shard(os.path.join(mocap_dir, "neutrSMPL_CMU_0.npz"), np.zeros((6, 72)), np.zeros((6, 10)))
    mocap = tdata.make_mocap_pipeline(cfg.replace(mocap_datasets=["CMU"]), synthetic_model(num_verts=30), device="cpu")
    assert isinstance(mocap, tnpz.NpzMocapPipeline) and mocap.pose.shape == (6, 72)


# ---------------------------------------------------------------------------
# npz converters


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in sorted(z.namelist())}


def test_converters_write_the_jax_packages_bytes(examples, tmp_path):
    """``convert_images_to_npz_shard`` (OpenCV) and
    ``convert_mocap_tfrecords_to_npz`` (TensorFlow) against the JAX
    package's on the same inputs: every array of the two shards byte-equal
    (the zip members; the archives' timestamps may differ)."""
    pytest.importorskip("tensorflow")
    _, pairs, joints = examples
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    assert tnpz.convert_images_to_npz_shard(ours, pairs, joints) == jnpz.convert_images_to_npz_shard(
        theirs, pairs, joints) == 12
    assert _members(ours) == _members(theirs)

    rng = np.random.RandomState(3)
    records = []
    for i, m in enumerate((5, 7)):
        path = str(tmp_path / f"neutrSMPL_CMU_{i}.tfrecord")
        jtfrecords.create_mocap_tfrecord(path, rng.randn(m, 72).astype(np.float32), rng.randn(m, 10).astype(np.float32))
        records.append(path)
    ours, theirs = str(tmp_path / "mocap_ours.npz"), str(tmp_path / "mocap_theirs.npz")
    assert tnpz.convert_mocap_tfrecords_to_npz(records, ours) == jnpz.convert_mocap_tfrecords_to_npz(
        records, theirs) == 12
    assert _members(ours) == _members(theirs)
