"""HMR 2.0's model in the port (``models/vit.py``, ``models/transformer_head.py``,
``core.rotations.rot6d_to_rotmat``, ``core.smpl.smpl_forward(...,
rotations=...)``, ``HMR`` with ``backbone='vit_h'``, ``head='transformer'``)
held against the benchmark's plain reference, ``portbench/reference/hmr2.py``,
on the CPU at a tiny size: a ViT of depth 2, width 64 and 4 heads (MLP 256,
stochastic depth to 0.55), a head of depth 2 and width 64 (4 heads of 16,
MLP 64), a 64 px crop of which the ViT sees 64 x 48 (12 tokens), batch 2,
a 200-vertex body, seeded weights from ``portbench/weights_hmr2.py``.

The modules are compared in float64, where the port and the reference do
the same arithmetic in another order: within 1e-10. The fused training
step is compared in float64 too, with every draw (augmentation,
stochastic depth, penalty uniforms) from one generator on both sides; its
silhouette chamfer computes in f32 on the port's path (``ops/losses.py``),
so the losses and gradients are held at rtol 1e-6."""
import numpy as np
import pytest
import torch

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.core import rotations as trot
from human_pose_estimation_tpu_torch.core.smpl import smpl_forward
from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models import encoder_graph
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.models.vit import ViT, ViTShape
from human_pose_estimation_tpu_torch.train import step as tstep
from human_pose_estimation_tpu_torch.train.state import create_train_state, step_generator
from human_pose_estimation_tpu_torch.train.trainer import Trainer
from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt
from human_pose_estimation_tpu_torch.utils import tracing
from portbench import harness as H
from portbench import traffic
from portbench import weights as W
from portbench import weights_hmr2 as WV
from portbench.glue import load_weights, program_body
from portbench.reference import hmr2 as ref
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

TINY = {"vit_depth": 2, "vit_width": 64, "vit_heads": 4, "vit_mlp": 256, "head_depth": 2, "head_width": 64,
        "head_heads": 4, "head_dim_head": 16, "head_mlp": 64, "img_size": 64, "num_verts": 200,
        "max_silhouette_points": 256, "batch_size": 2}
F64 = torch.float64
DRIVER = H.load_module("drivers", "train_hmr2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """(the cell's configuration at the tiny size, the port's Config, the
    body model's tensors, the HMR weights, the mean, the critic's weights)."""
    cfg = {**H.cell(H.benchmark(), "vith-train-b48")[1], **TINY}
    dev = torch.device("cpu")
    hmr_sd, mean = WV.make_hmr2(cfg, 11, dev)
    return cfg, DRIVER.model_config(cfg, 11), W.make_body(cfg, 11, dev), hmr_sd, mean, W.make_critic(cfg, 11, dev)


def _hmr(tiny, dtype=F64) -> HMR:
    cfg, pcfg, body, hmr_sd, _, _ = tiny
    hmr = HMR.from_config(program_body(body, "cpu"), pcfg, device="cpu")
    hmr.load_state_dict(hmr_sd)
    hmr.to(dtype)
    hmr.smpl = hmr.smpl.to("cpu", dtype)
    return hmr


def _images(n=2, seed=0):
    return torch.rand(n, 64, 64, 3, generator=torch.Generator().manual_seed(seed), dtype=F64) * 2 - 1


@pytest.mark.parametrize("train", [False, True])
def test_vit_features_match_the_reference(tiny, train):
    cfg, _, _, hmr_sd, _, _ = tiny
    hmr = _hmr(tiny)
    hmr.train(train)
    p = {k: v.to(F64) for k, v in hmr_sd.items()}
    x = _images()
    got = hmr.encoder(x, hmr.encoder.draw_masks(2, torch.Generator().manual_seed(5)))
    want = ref.vit(x, p, cfg, train, torch.Generator().manual_seed(5))
    assert got.shape == (2, 12, 64)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    if train:  # block 2 drops rows at 0.55: its masks are the reference's
        assert not torch.allclose(got, ref.vit(x, p, cfg, False))


def test_head_matches_the_reference(tiny):
    cfg, _, _, hmr_sd, mean, _ = tiny
    hmr = _hmr(tiny)
    p = {k: v.to(F64) for k, v in hmr_sd.items()}
    context = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(1), dtype=F64)
    got = hmr.head(context, hmr.head.initial(mean.to(F64), 2))
    pose = ref.rotmat_to_rot6d(ref_model.rodrigues(mean[:, 3:75].to(F64).reshape(-1, 24, 3))).reshape(1, 144)
    m = mean.to(F64)
    want = ref.head(context, p, (m[:, :3].expand(2, -1), pose.expand(2, -1), m[:, 75:].expand(2, -1)), cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_rot6d_to_rotmat_is_a_rotation_and_the_references():
    x = torch.randn(50, 6, generator=torch.Generator().manual_seed(2), dtype=F64)
    r = trot.rot6d_to_rotmat(x)
    torch.testing.assert_close(r.transpose(-1, -2) @ r, torch.eye(3, dtype=F64).expand(50, 3, 3))
    torch.testing.assert_close(torch.linalg.det(r), torch.ones(50, dtype=F64))
    torch.testing.assert_close(r, ref.rot6d_to_rotmat(x), rtol=1e-12, atol=1e-12)
    # the 6D form of a rotation maps back to it
    torch.testing.assert_close(trot.rot6d_to_rotmat(trot.rotmat_to_rot6d(r)), r)
    torch.testing.assert_close(trot.rotmat_to_rot6d(r), ref.rotmat_to_rot6d(r))


def test_smpl_from_matrices_equals_smpl_from_axis_angle(tiny):
    hmr = _hmr(tiny)
    g = torch.Generator().manual_seed(3)
    beta, theta = torch.randn(3, 10, generator=g, dtype=F64), 0.4 * torch.randn(3, 72, generator=g, dtype=F64)
    a = smpl_forward(hmr.smpl, beta, theta, "lsp")
    b = smpl_forward(hmr.smpl, beta, None, "lsp", rotations=trot.rodrigues(theta.reshape(3, 24, 3)))
    for k in ("verts", "joints", "rotations", "joints_smpl"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0, atol=0)
    body = ref_model.Body(*(t.to(F64) for t in tiny[2]))
    verts, joints, _ = ref.smpl_from_rotations(body, beta, b.rotations)
    torch.testing.assert_close(b.verts, verts, rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="exactly one"):
        smpl_forward(hmr.smpl, beta, theta, "lsp", rotations=b.rotations)


@pytest.fixture
def _preprocessed_f64(monkeypatch):
    """``DevicePreprocessor``'s f32 batch cast to f64 as it leaves (the step
    runs in f64)."""
    call = DevicePreprocessor.__call__
    monkeypatch.setattr(DevicePreprocessor, "__call__", lambda self, *a: tstep.GenBatch(
        *(t.to(F64) if t.is_floating_point() else t for t in call(self, *a))))


def test_one_fused_train_step_matches_the_reference_in_float64(tiny, _preprocessed_f64):
    cfg, pcfg, body, hmr_sd, mean, critic_sd = tiny
    host = traffic.canvases(traffic.rng(4, 1), 1, 2, 256)[0]
    pose, shape = (a.astype(np.float64) for a in traffic.mocap(traffic.rng(4, 2), 1, 2)[0])

    state = create_train_state(program_body(body, "cpu"), mean.numpy(), pcfg, device="cpu")
    load_weights(state, hmr_sd, mean, critic_sd)
    state.hmr.to(F64)
    state.hmr.smpl = state.hmr.smpl.to("cpu", F64)
    state.critic.to(F64)
    state.mean_theta.data = state.mean_theta.data.to(F64)
    smpl = program_body(body, "cpu").to("cpu", F64)
    fused = tstep.make_fused_train_step(pcfg, smpl, device="cpu")
    host_b = tstep.HostBatch(*(torch.from_numpy(host[k]) for k in ("image", "seg", "hw", "center", "label")))
    got = fused(state, host_b, (torch.from_numpy(pose), torch.from_numpy(shape)), step_generator(7, 0, "cpu"))

    rstate = ref.new_state({k: v.to(F64) for k, v in hmr_sd.items()}, mean.to(F64),
                           {k: v.to(F64) for k, v in critic_sd.items()}, cfg)
    want = ref.train_step(rstate, ref_model.Body(*(t.to(F64) for t in body)), cfg,
                          {k: torch.from_numpy(v) for k, v in host.items()},
                          (torch.from_numpy(pose), torch.from_numpy(shape)), ref_train.step_generator(7, 0, "cpu"))
    for k in ("kpr_losses", "mr_losses", "gen_critic_losses", "generator_loss", "critic_loss", "critic_penalty"):
        # the silhouette loss is an f32 sum on the port's path
        torch.testing.assert_close(getattr(got, k), want[k], rtol=1e-6, atol=1e-9, check_dtype=False)
    grads = DRIVER.T._first_grads(state)
    ref_grads = {**want["gen_grads"], **{"critic." + k: v for k, v in want["critic_grads"].items()}}
    assert set(grads) == set(ref_grads)
    scale = max(float(v.abs().max()) for v in ref_grads.values())
    for k, v in ref_grads.items():
        torch.testing.assert_close(grads[k], v, rtol=1e-6, atol=1e-9 * scale)
    # the penalty's uniforms are drawn after the stochastic-depth masks: its
    # equal value shows both sides drew the same masks from the generator
    assert float(want["critic_penalty"]) > 0


def _trainer(tiny, tmp_path, **kw):
    cfg, pcfg, body, hmr_sd, mean, critic_sd = tiny
    host = traffic.canvases(traffic.rng(6, 1), 2, 2, 256)
    batches = [(tstep.HostBatch(*(torch.from_numpy(h[k]) for k in ("image", "seg", "hw", "center", "label"))), 2)
               for h in host]
    mocap = [tuple(torch.from_numpy(a) for a in m) for m in traffic.mocap(traffic.rng(6, 2), 2, 2)]
    pcfg = pcfg.replace(encoder_dtype="float32", checkpoint_dir=str(tmp_path / "ckpt"), **kw)
    t = Trainer(pcfg, dataset=iter(batches * 4), mocap_dataset=iter(mocap * 4), smpl=program_body(body, "cpu"),
                device="cpu")
    load_weights(t.state, hmr_sd, mean, critic_sd)
    return t


def test_trainer_checkpoint_round_trip_and_the_other_entry_points(tiny, tmp_path):
    t = _trainer(tiny, tmp_path)
    history = t.train(max_steps=2)
    assert len(history["kpr"]) == 2 and all(np.isfinite(history["kpr"]))
    ckpt.save_train_state(str(tmp_path / "ckpt"), t.state, step=t.state.step)
    fresh = _trainer(tiny, tmp_path)
    restored, step = ckpt.restore_train_state(str(tmp_path / "ckpt"), fresh.state)
    assert step == 2
    a, b = t.state.state_dict(), restored.state_dict()
    for k in ("hmr", "critic"):
        assert all(torch.equal(a[k][n], b[k][n]) for n in a[k]), k
    assert all(torch.equal(a["gen_adam"]["exp_avg"][n], b["gen_adam"]["exp_avg"][n]) for n in a["gen_adam"]["exp_avg"])

    # evaluation and serving run the same model, in eval mode (no draws)
    host = traffic.canvases(traffic.rng(6, 1), 1, 2, 256)[0]
    batch = DevicePreprocessor(t.config, augment=False, device="cpu")(
        {k: torch.from_numpy(host[k]) for k in ("image", "seg", "hw", "center", "label")})
    out = tstep.make_val_step(t.state.hmr, t.state.critic, t.config)(t.state.mean_theta, batch)
    assert out["verts"].shape == (2, 200, 3) and torch.isfinite(out["kpr_losses"]).all()
    # the unfused step on a prepared batch
    mocap = tstep.mocap_batch(t.smpl, *(torch.from_numpy(a) for a in traffic.mocap(traffic.rng(6, 2), 1, 2)[0]))
    m = tstep.make_train_step(t.config, device="cpu")(t.state, batch, mocap, step_generator(1, 2, "cpu"))
    assert t.state.step == 3 and torch.isfinite(m.generator_loss) and torch.isfinite(m.critic_loss)
    pred = Predictor(t.config, smpl=t.smpl, variables=t.state.hmr.state_dict(),
                     mean_theta=t.state.mean_theta.detach(), device="cpu")
    got = pred.predict(host["image"][:, 96:160, 96:160])
    assert got["theta"].shape == (2, 3 + 144 + 10) and got["generated_verts"].shape == (2, 200, 3)


def test_spans_of_the_model(tiny):
    """Under a profiler a forward of num_stage head iterations enters
    model.encoder once and model.head and model.smpl once an iteration."""
    from torch.profiler import ProfilerActivity, profile

    hmr = _hmr(tiny)
    hmr.num_stage = 2
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        stages = hmr(_images(), tiny[4].to(F64))
    names = [s.name for s in tracing.take()]
    assert [names.count(n) for n in ("model.encoder", "model.head", "model.smpl", "model.ief")] == [1, 2, 2, 0]
    assert len(stages) == 2 and stages[1].rotations.shape == (2, 23, 3, 3)


@pytest.mark.parametrize("pair", ["resnet-ief", "vit_h-transformer"])
def test_both_pairs_share_the_model_seam(tiny, pair):
    """Either pair through ``HMR``'s one seam: ``draw_masks`` draws nothing
    in eval mode, nor from the ResNet in train mode; a train-mode forward
    enters its head's span once a stage, and ``model.smpl`` once a stage
    with ``smpl_stages='all'`` and once with ``'last'``."""
    from torch.profiler import ProfilerActivity, profile

    if pair == "resnet-ief":
        hmr = HMR(program_body(tiny[2], "cpu"), encoder_stage_sizes=(1, 1, 1, 1), device="cpu")
        head_span, drawless = "model.ief", (False, True)
    else:
        hmr = _hmr(tiny, torch.float32)
        hmr.num_stage = 3  # HMR 2.0 runs one iteration
        head_span, drawless = "model.head", (False,)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    for train in drawless:
        hmr.train(train)
        assert hmr.encoder.draw_masks(2, gen) is None
    assert torch.equal(gen.get_state(), state)
    hmr.train()
    for smpl_stages, with_body in (("all", [True] * 3), ("last", [False, False, True])):
        tracing.take()
        with profile(activities=[ProfilerActivity.CPU]):
            stages = hmr(_images().float(), tiny[4], smpl_stages=smpl_stages, generator=gen)
        names = [s.name for s in tracing.take()]
        assert names.count(head_span) == hmr.num_stage == 3
        assert names.count("model.smpl") == sum(with_body)
        assert [s.verts is not None for s in stages] == with_body
    assert not torch.equal(gen.get_state(), state)  # IEF's dropout, or the ViT's masks, drew


def test_the_encoder_graph_remat_and_int8_leave_the_vit_alone(tiny):
    hmr = _hmr(tiny, torch.float32)
    hmr.train()
    # the ViT draws its masks up front, so only the device keeps it eager here
    assert encoder_graph.bypass(hmr, _images().float()) == "not on a CUDA device"
    with pytest.raises(ValueError, match="int8"):
        hmr.quantize_encoder()
    with pytest.raises(ValueError, match="remat_encoder"):
        HMR.from_config(hmr.smpl, tiny[1], device="cpu", remat_encoder=True)
    with pytest.raises(ValueError, match="backbone, head"):
        HMR.from_config(hmr.smpl, Config(backbone="vit_h", head="ief"), device="cpu")


def _per_block_forward(vit: ViT, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The ViT's train-mode forward with its masks drawn block by block,
    inside the forward, as the model drew them before ``draw_masks``: one
    (N,) uniform per branch at a rate above 0, ``floor(keep + u)``, then
    ``x / keep * mask``."""
    def drop(x, rate):
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.floor(keep + torch.rand((x.shape[0],), generator=generator, device=x.device))
        return x / keep * mask.to(x.dtype).reshape(-1, 1, 1)

    x = images[:, :, vit.col0 : images.shape[2] - vit.col0].permute(0, 3, 1, 2)
    x = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
    x = x + vit.pos_embed[:, 1:] + vit.pos_embed[:, :1]
    for b in vit.blocks:
        x = x + drop(b.attn(b.norm1(x)), b.rate)
        x = x + drop(b.mlp(b.norm2(x)), b.rate)
    return vit.last_norm(x)


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_masks_drawn_up_front_equal_the_per_block_draws(dtype):
    """A ViT of depth 4 (rates 0, 0.18, 0.37, 0.55): the masks that
    ``draw_masks`` draws and the forward applies give the outputs and every
    parameter gradient of the per-block draws bit for bit, from the same
    seeded generator, which then draws the same next numbers."""
    vit = ViT(64, ViTShape(depth=4, width=32, heads=2, mlp=64)).to(dtype)
    vit.reset_parameters(torch.Generator().manual_seed(3))
    vit.train()
    n = 8
    x = _images(n).to(dtype)
    up_front, per_block = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    masks = vit.draw_masks(n, up_front)
    assert masks.shape == (6, n) and masks.dtype == torch.float32
    assert set(masks.unique().tolist()) == {0.0, 1.0}  # rows dropped and rows kept
    got, want = vit(x, masks), _per_block_forward(vit, x, per_block)
    assert torch.equal(got, want)
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(4), dtype=dtype)
    params = list(vit.parameters())
    for a, b in zip(torch.autograd.grad((got * w).sum(), params), torch.autograd.grad((want * w).sum(), params)):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(5, generator=up_front), torch.rand(5, generator=per_block))
    with pytest.raises(ValueError, match="draw_masks"):
        vit(x)
    with pytest.raises(ValueError, match="draw_masks"):
        vit(x, masks[:4])
    # eval mode draws nothing and applies no mask
    vit.eval()
    state = up_front.get_state()
    assert vit.draw_masks(n, up_front) is None and torch.equal(up_front.get_state(), state)
    assert torch.isfinite(vit(x)).all()
