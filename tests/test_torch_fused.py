"""The port's fused training step, its multi-step form and the
rematerialised encoder, on the CPU at a small size (a (1,1,1,1) encoder,
uint8 canvases of 96 px cropped to 64, the 120-vertex asset, batch 4, a
512-pixel silhouette budget, 12 mocap samples).

The fused step is held against the port's own unfused composition
(``DevicePreprocessor``, the body-model forward of the mocap, then
``make_train_step``, which tests/test_torch_train.py holds against the
JAX step): metrics within rtol 1e-5 and parameters within 1e-6.
``make_multi_step`` against sequential calls, and the rematerialised
encoder against the plain one: bit-equal (the same operations on the same
inputs in the same order on the CPU)."""
import numpy as np
import pytest
import torch

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.core.smpl import smpl_forward
from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor
from human_pose_estimation_tpu_torch.train import step as tstep
from human_pose_estimation_tpu_torch.train.state import TrainState, create_train_state
from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

CANVAS, IMG, BATCH, NSIL = 96, 64, 4, 512
MOCAP = 3 * BATCH


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small steps gain nothing from more, and
    with the suite's parallel workers more threads only contend (the
    comparisons are within one thread setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw) -> Config:
    base = dict(
        img_size=IMG, batch_size=BATCH, encoder_stage_sizes="1,1,1,1", encoder_dtype="float32",
        use_mesh_repro_loss=True, max_silhouette_points=NSIL, trans_max=8,
    )
    base.update(kw)
    return Config(**base)


def _host_batch(seed: int) -> tstep.HostBatch:
    """uint8 canvases with a filled figure-like blob in the seg, 19
    keypoints in (3, 19), the true extent and the centre."""
    rng = np.random.RandomState(seed)
    image = np.zeros((BATCH, CANVAS, CANVAS, 3), np.uint8)
    seg = np.zeros((BATCH, CANVAS, CANVAS, 1), np.uint8)
    hw = rng.randint(72, CANVAS + 1, (BATCH, 2)).astype(np.int32)
    center = np.zeros((BATCH, 2), np.int32)
    label = np.zeros((BATCH, 3, 19), np.float32)
    for b, (h, w) in enumerate(hw):
        image[b, :h, :w] = rng.randint(0, 256, (h, w, 3))
        cx, cy = w // 2 + rng.randint(-4, 5), h // 2 + rng.randint(-4, 5)
        yy, xx = np.mgrid[:h, :w]
        seg[b, :h, :w, 0] = 255 * ((((yy - cy) / 24.0) ** 2 + ((xx - cx) / 10.0) ** 2) < 1.0)
        center[b] = cx, cy
        label[b, 0] = cx + rng.randn(19) * 8
        label[b, 1] = cy + rng.randn(19) * 16
        label[b, 2] = rng.rand(19) > 0.2
    return tstep.HostBatch(image, seg, hw, center, label)


def _mocap_raw(seed: int):
    rng = np.random.RandomState(100 + seed)
    return (rng.randn(MOCAP, 72) * 0.2).astype(np.float32), (rng.randn(MOCAP, 10) * 0.4).astype(np.float32)


def _state(cfg: Config) -> TrainState:
    return create_train_state(synthetic_model(num_verts=120, seed=0), synthetic_mean_params(), cfg, device="cpu")


def _params(state: TrainState):
    named = list(state.hmr.named_parameters()) + [("mean_theta", state.mean_theta)]
    named += [(f"critic.{k}", p) for k, p in state.critic.named_parameters()]
    return {k: p.detach().clone() for k, p in named}


def _metrics(m: tstep.StepMetrics):
    return {k: v.detach().clone() for k, v in vars(m).items()}


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("with_mocap", [True, False])
def test_fused_step_equals_its_composition(augment, with_mocap):
    cfg = _cfg()
    smpl = synthetic_model(num_verts=120, seed=0)
    host = _host_batch(0)
    raw = _mocap_raw(0) if with_mocap else None

    fused_state = _state(cfg)
    fused = tstep.make_fused_train_step(cfg, smpl, augment=augment, device="cpu")
    got = fused(fused_state, host, raw, torch.Generator().manual_seed(0))

    ref_state = _state(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = DevicePreprocessor(cfg, augment=augment, device="cpu")(host._asdict(), gen)
    mocap = None
    if with_mocap:
        pose, shape = (torch.from_numpy(a) for a in raw)
        out = smpl_forward(smpl, shape, pose, joint_type="cocoplus")
        mocap = tstep.MocapBatch(out.joints, shape, out.rotations[:, 1:])
    ref = tstep.make_train_step(cfg, device="cpu")(ref_state, batch, mocap, gen)

    assert fused_state.step == ref_state.step == 1
    assert int(batch.seg_mask.sum(dim=1).min()) > 200  # a real silhouette per image
    for k, v in _metrics(ref).items():
        torch.testing.assert_close(getattr(got, k), v, rtol=1e-5, atol=1e-5 * float(v.abs().max()), msg=k)
    assert float(got.mr_losses[-1]) > 0 and (float(got.critic_loss) != 0.0) == with_mocap
    after, ref_after = _params(fused_state), _params(ref_state)
    for k, v in ref_after.items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=1e-6, msg=k)
    for k, v in ref_state.hmr.state_dict().items():  # the BN statistics too
        torch.testing.assert_close(fused_state.hmr.state_dict()[k], v, rtol=0, atol=1e-6, msg=k)


def test_multi_step_equals_sequential_calls():
    cfg = _cfg()
    smpl = synthetic_model(num_verts=120, seed=0)
    k = 3
    hosts = [_host_batch(i) for i in range(k)]
    raws = [_mocap_raw(i) for i in range(k)]
    fused = tstep.make_fused_train_step(cfg, smpl, device="cpu")

    seq_state, multi_state = _state(cfg), _state(cfg)  # one seed: equal states
    gen = torch.Generator().manual_seed(7)
    seq = [_metrics(fused(seq_state, h, r, gen)) for h, r in zip(hosts, raws)]
    stacked = tstep.make_multi_step(fused, k)(multi_state, hosts, raws, torch.Generator().manual_seed(7))

    assert multi_state.step == seq_state.step == k
    for name, v in vars(stacked).items():
        assert v.shape[0] == k, name
        for j in range(k):
            assert torch.equal(v[j], seq[j][name]), (name, j)
    assert len({float(m["generator_loss"]) for m in seq}) == k  # three different steps
    after, seq_after = _params(multi_state), _params(seq_state)
    for name, v in seq_after.items():
        assert torch.equal(after[name], v), name
    with pytest.raises(ValueError, match="3 batches"):
        tstep.make_multi_step(fused, k)(multi_state, hosts[:2], raws[:2], gen)


def test_multi_step_without_mocap():
    cfg = _cfg()
    multi = tstep.make_multi_step(tstep.make_fused_train_step(cfg, synthetic_model(num_verts=120), device="cpu"), 2)
    state = _state(cfg)
    out = multi(state, [_host_batch(3), _host_batch(4)], None, torch.Generator().manual_seed(0))
    assert state.step == 2 and out.critic_loss.tolist() == [0.0, 0.0] and out.kpr_losses.shape == (2, 3)


def test_remat_encoder_matches_and_updates_bn_statistics_once():
    """One fused step with the rematerialised encoder against the plain
    one from the same state and generator seed: equal metrics, parameters
    and BN running statistics (bit for bit), and the encoder really ran
    twice (the forward and its recompute), so the statistics were frozen
    in the recompute."""
    smpl = synthetic_model(num_verts=120, seed=0)
    host, raw = _host_batch(5), _mocap_raw(5)
    runs = {}
    for remat in (False, True):
        cfg = _cfg(remat_encoder=remat)
        state = _state(cfg)
        assert state.hmr.remat_encoder is remat
        calls = []
        hook = state.hmr.encoder.conv1.register_forward_hook(lambda *a: calls.append(1))
        m = tstep.make_fused_train_step(cfg, smpl, device="cpu")(state, host, raw, torch.Generator().manual_seed(1))
        hook.remove()
        runs[remat] = (len(calls), _metrics(m), _params(state), state.hmr.state_dict())
        # after the step every BN layer updates its statistics again
        assert all(bn.update_running_stats for bn in state.hmr.encoder.modules() if hasattr(bn, "update_running_stats"))
    (n_plain, m_plain, p_plain, sd_plain), (n_remat, m_remat, p_remat, sd_remat) = runs[False], runs[True]
    assert (n_plain, n_remat) == (1, 2)
    for k, v in m_plain.items():
        assert torch.equal(m_remat[k], v), k
    for k, v in p_plain.items():
        assert torch.equal(p_remat[k], v), k
    stats = [k for k in sd_plain if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert len(stats) > 20
    for k in stats:
        assert torch.equal(sd_remat[k], sd_plain[k]), k
    assert int(sd_remat["encoder.bn1.num_batches_tracked"]) == 1
