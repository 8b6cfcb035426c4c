"""Multi-HMR's model in the port (``models/vit.py`` with ``DINOV2``,
``models/transformer_head.HumanPredictionHead``, ``core.smpl`` on SMPL-X's
layout, ``core.projection.perspective_project``, ``data.augment.
augment_slots``, ``data.pipeline.SlotPreprocessor`` and the person-slot
losses of ``train/step.py``; ``HMR`` with ``backbone='dinov2_l14'``,
``head='hph'``) held against the benchmark's plain reference,
``portbench/reference/multihmr.py``, on the CPU at a tiny size: a ViT of
depth 2 and width 32 (2 heads, MLP 64) on 56 px images of 4 x 4 patches
(its position embedding resized from DINOv2's 37 x 37), a head of depth 2
and width 32, SMPL-X's 55-joint tree on a seeded 64-vertex mesh, K = 3
person slots with some empty, batch 2, seeded weights from
``portbench/weights_mhmr.py``.

The modules are compared in float64, where the port and the reference do
the same arithmetic in another order: within 1e-10. The fused training
steps are compared in float64 too, every draw from one generator on both
sides; the silhouette chamfer computes in f32 on the port's path, so the
losses and gradients are held at rtol 1e-6.

A second group holds what the generalisation must leave alone: HMR 2.0's
ViT and the SMPL body model give the outputs of their code before it,
copied here, bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.core import rotations as trot
from human_pose_estimation_tpu_torch.core.smpl import SMPL_LAYOUT, SMPLX_LAYOUT, smpl_forward
from human_pose_estimation_tpu_torch.data.augment import FLIP_SWAP_19, AugmentConfig, augment_slots
from human_pose_estimation_tpu_torch.data.pipeline import SlotPreprocessor
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.models.transformer_head import HeadShape
from human_pose_estimation_tpu_torch.models.vit import ViT, ViTShape, drop_path
from human_pose_estimation_tpu_torch.train import step as tstep
from human_pose_estimation_tpu_torch.train.state import create_train_state, step_generator
from human_pose_estimation_tpu_torch.utils import tracing
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model
from portbench import harness as H
from portbench import traffic_crowd as TC
from portbench import weights_mhmr as WM
from portbench.glue import load_weights
from portbench.reference import hmr2 as ref_hmr2
from portbench.reference import multihmr as ref
from portbench.reference import train as ref_train

TINY = {"vit_depth": 2, "vit_width": 32, "vit_heads": 2, "vit_mlp": 64, "head_depth": 2, "head_width": 32,
        "head_heads": 2, "head_dim_head": 16, "head_mlp": 32, "img_size": 56, "num_verts": 64,
        "max_silhouette_points": 256, "batch_size": 2, "person_slots": 3}
F64 = torch.float64
DRIVER = H.load_module("drivers", "train_mhmr")
HOST = ("image", "seg", "center", "label", "present")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """(the cell's configuration at the tiny size, the port's Config, SMPL-X's
    tensors, the HMR weights, the mean, the critic's weights)."""
    cfg = {**H.cell(H.benchmark(), "mhmr-train-b8")[1], **TINY}
    dev = torch.device("cpu")
    hmr_sd, mean = WM.make_mhmr(cfg, 11, dev)
    return cfg, DRIVER.model_config(cfg, 11), WM.make_body(cfg, 11, dev), hmr_sd, mean, WM.make_critic(cfg, 11, dev)


def _host(seed=4, count=1):
    """Whole 56 px images: image 0 with three people, image 1 with one (its
    slots 1 and 2 empty)."""
    out = []
    for h in TC.canvases(TC.rng(seed, 1), count, 2, 56, 3, 20, 40):
        h["present"][0] = 1
        h["present"][1] = (1, 0, 0)
        h["seg"][1] &= 1
        h["label"][1, 1:] = 0
        h["center"][1, 1:] = 0
        for k in range(3):  # image 0's people, wherever the generator left them
            h["center"][0, k] = (12 + 16 * k, 28)
        out.append(h)
    return out


def _mocap(seed=4, count=1):
    return TC.mocap(TC.rng(seed, 2), count, 6)


def _hmr(tiny, dtype=F64) -> HMR:
    _, pcfg, body, hmr_sd, _, _ = tiny
    hmr = HMR.from_config(WM.program_body(body, "cpu"), pcfg, device="cpu")
    hmr.load_state_dict(hmr_sd)
    hmr.to(dtype)
    hmr.smpl = hmr.smpl.to("cpu", dtype)
    return hmr


def _body64(tiny):
    return ref.BodyX(*(t.to(F64) for t in tiny[2]))


def _prepared(tiny):
    """The port's and the reference's slot batch of ``_host``'s images,
    centre-cropped."""
    cfg = tiny[0]
    h = _host()[0]
    prep = SlotPreprocessor(tiny[1], augment=False, device="cpu")
    return prep({k: torch.from_numpy(h[k]) for k in HOST}), ref.prepare({k: torch.from_numpy(h[k]) for k in HOST},
                                                                          cfg, augment_=False)


def test_the_layouts_of_smpl_and_smplx():
    assert SMPL_LAYOUT.num_joints == 24 and SMPL_LAYOUT.pose_features == 207 and SMPL_LAYOUT.num_expression == 0
    assert SMPLX_LAYOUT.num_joints == 55 and SMPLX_LAYOUT.pose_features == 486
    assert (SMPLX_LAYOUT.num_verts, SMPLX_LAYOUT.num_expression) == (10475, 10)
    assert SMPLX_LAYOUT.parents == ref.PARENTS
    assert synthetic_model(num_verts=120, seed=0).layout == SMPL_LAYOUT._replace(num_verts=120)


def test_the_input_path_matches_the_reference(tiny):
    got, want = _prepared(tiny)
    assert got.valid.tolist() == [[1.0, 1.0, 1.0], [1.0, 0.0, 0.0]] == want.valid.tolist()
    for k in ("images", "seg_points", "seg_mask", "kp2d", "centers"):
        torch.testing.assert_close(getattr(got, k), getattr(want, k), rtol=0, atol=1e-6, msg=k)
    assert got.seg_mask.reshape(2, 3, -1)[1, 1:].sum() == 0 and got.kp2d.reshape(2, 3, 19, 3)[1, 1:].sum() == 0


def test_only_a_head_that_takes_person_slots_is_given_them(tiny):
    """The HPH refuses a call without person slots and a crop head one with
    them, naming the model, before the encoder runs."""
    got, _ = _prepared(tiny)
    mean = tiny[4].to(F64)
    with pytest.raises(ValueError, match=r"dinov2_l14.*takes person slots"):
        _hmr(tiny)(got.images.to(F64), mean)
    crop = HMR(synthetic_model(num_verts=120, seed=0), backbone="vit_h", head="transformer", img_size=64,
               vit_shape=ViTShape(1, 32, 2, 64), head_shape=HeadShape(1, 32, 2, 16, 32), device="cpu")
    with pytest.raises(ValueError, match=r"vit_h.*takes no person slots"):
        crop(torch.zeros(2, 64, 64, 3), mean.float(), slots=got.slots)


def test_a_flipped_batch_swaps_left_and_right_joints():
    """Every person's keypoints, centre and silhouette move with the flip:
    x mirrored about the crop, the left and right joints swapped, the
    silhouettes' columns reversed."""
    h = _host()[0]
    args = [torch.from_numpy(h[k]) for k in HOST]
    cfg = AugmentConfig(out_size=56)
    trans, scales = torch.tensor([[3, -2], [-4, 1]], dtype=torch.int32), torch.tensor([1.1, 0.9])
    plain = augment_slots(*args, None, cfg, overrides=(trans, scales, torch.tensor([False, False])))
    flipped = augment_slots(*args, None, cfg, overrides=(trans, scales, torch.tensor([True, True])))
    (_, seg, lab, ctr, valid), (_, seg_f, lab_f, ctr_f, valid_f) = plain, flipped
    assert torch.equal(valid, valid_f) and valid.sum() == 4
    assert torch.equal(seg_f, seg.flip(2))
    swap = list(FLIP_SWAP_19)
    assert not torch.equal(lab_f, lab)
    torch.testing.assert_close(lab_f[..., 0], (-lab[..., swap, 0] - 2.0 / 56) * lab[..., swap, 2])
    torch.testing.assert_close(lab_f[..., 1:], lab[..., swap, 1:])
    torch.testing.assert_close(ctr_f[..., 0], 55.0 - ctr[..., 0])
    torch.testing.assert_close(ctr_f[..., 1], ctr[..., 1])


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_reference(tiny, train):
    cfg, _, _, hmr_sd, mean, _ = tiny
    hmr = _hmr(tiny)
    hmr.train(train)
    batch, _ = _prepared(tiny)
    p = {k: v.to(F64) for k, v in hmr_sd.items()}
    images = batch.images.to(F64)
    gen = torch.Generator().manual_seed(3)
    (got,) = hmr(images, mean.to(F64), generator=gen, slots=(batch.centers.to(F64), batch.valid.to(F64)))
    want = ref.multihmr(images, batch.centers.to(F64), batch.valid.to(F64), mean.to(F64), p, _body64(tiny), cfg)
    assert got.verts.shape == (6, 64, 3) and got.rotations.shape == (6, 54, 3, 3) and got.detection.shape == (2, 16)
    pairs = {"cam": (got.theta[:, :3], want.cam), "translation": (got.cam, want.translation), "shape": (got.shape, want.shape),
             "verts": (got.verts, want.verts), "joints": (got.joints3d, want.joints), "rotations": (got.rotations, want.rotations),
             "kp2d": (got.kp2d, want.kp2d), "detection": (got.detection, want.detection)}
    for k, (a, b) in pairs.items():
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=k)
    assert torch.equal(got.patches, want.patches)
    # the eyes stay at identity
    assert torch.equal(got.rotations[:, 22:24], torch.eye(3, dtype=F64).expand(6, 2, 3, 3))


def _states(tiny):
    cfg, pcfg, body, hmr_sd, mean, critic_sd = tiny
    state = create_train_state(WM.program_body(body, "cpu"), mean.numpy(), pcfg, device="cpu")
    load_weights(state, hmr_sd, mean, critic_sd)
    state.hmr.to(F64)
    state.hmr.smpl = state.hmr.smpl.to("cpu", F64)
    state.critic.to(F64)
    state.mean_theta.data = state.mean_theta.data.to(F64)
    rstate = ref.new_state({k: v.to(F64) for k, v in hmr_sd.items()}, mean.to(F64),
                           {k: v.to(F64) for k, v in critic_sd.items()}, cfg)
    return state, rstate


@pytest.fixture
def _preprocessed_f64(monkeypatch):
    """``SlotPreprocessor``'s f32 batch cast to f64 as it leaves (the step
    runs in f64)."""
    call = SlotPreprocessor.__call__
    monkeypatch.setattr(SlotPreprocessor, "__call__", lambda self, *a: tstep.SlotBatch(
        *(t.to(F64) if t.is_floating_point() else t for t in call(self, *a))))


METRICS = ("kpr_losses", "mr_losses", "gen_critic_losses", "generator_loss", "critic_loss", "critic_penalty",
           "detection_loss")


def _fused_steps(tiny, hosts, mocaps):
    """Each fused step's metrics and the first step's gradients, of the port
    and of the reference, and both states after the steps."""
    cfg, pcfg, body = tiny[:3]
    state, rstate = _states(tiny)
    fused = tstep.make_fused_train_step(pcfg, WM.program_body(body, "cpu").to("cpu", F64), device="cpu")
    got, want, grads = [], [], None
    for s, (h, (pose, shape)) in enumerate(zip(hosts, mocaps)):
        pose, shape = torch.from_numpy(pose.astype(np.float64)), torch.from_numpy(shape.astype(np.float64))
        host_b = tstep.CrowdHostBatch(*(torch.from_numpy(h[k]) for k in HOST))
        got.append(fused(state, host_b, (pose, shape), step_generator(7, s, "cpu")))
        want.append(ref.train_step(rstate, _body64(tiny), cfg, {k: torch.from_numpy(v) for k, v in h.items()},
                                   (pose, shape), ref_train.step_generator(7, s, "cpu")))
        if s == 0:
            grads = DRIVER.T._first_grads(state)
    return got, want, grads, state, rstate


def test_one_fused_step_matches_the_reference_losses_and_every_first_gradient(tiny, _preprocessed_f64):
    got, want, grads, _, _ = _fused_steps(tiny, _host(), _mocap())
    for k in METRICS:
        torch.testing.assert_close(getattr(got[0], k), want[0][k], rtol=1e-6, atol=1e-9, check_dtype=False, msg=k)
    assert float(want[0]["detection_loss"]) > 0 and float(want[0]["critic_penalty"]) > 0
    ref_grads = {**want[0]["gen_grads"], **{"critic." + k: v for k, v in want[0]["critic_grads"].items()}}
    assert set(grads) == set(ref_grads)
    scale = max(float(v.abs().max()) for v in ref_grads.values())
    for k, v in ref_grads.items():
        torch.testing.assert_close(grads[k], v, rtol=1e-6, atol=1e-9 * scale, msg=k)


def test_three_fused_steps_match_the_reference(tiny, _preprocessed_f64):
    got, want, _, state, rstate = _fused_steps(tiny, _host(5, 3), _mocap(5, 3))
    for g, w in zip(got, want):
        for k in METRICS:
            torch.testing.assert_close(getattr(g, k), w[k], rtol=1e-6, atol=1e-9, check_dtype=False, msg=k)
    leaves = {**dict(state.hmr.named_parameters()), "mean_theta": state.mean_theta}
    for k, v in rstate.gen.items():
        torch.testing.assert_close(leaves[k].detach(), v, rtol=1e-6, atol=1e-10, msg=k)
    for k, v in state.critic.named_parameters():
        torch.testing.assert_close(v.detach(), rstate.critic[k], rtol=1e-6, atol=1e-10, msg=k)


def test_an_empty_slot_changes_nothing(tiny, _preprocessed_f64):
    """Image 1's empty slots filled with a person's centre, keypoints and
    silhouette bit while ``present`` stays 0: the step's losses and every
    first gradient are the same bits."""
    runs = []
    for fill in (False, True):
        h = _host()[0]
        if fill:
            h["center"][1, 2] = (30, 30)
            h["label"][1, 2] = h["label"][0, 0]
            h["seg"][1] |= (h["seg"][0] & 1) << 2
        got, _, grads, _, _ = _fused_steps(tiny, [h], _mocap())
        runs.append((got[0], grads))
    (a, ga), (b, gb) = runs
    for k in METRICS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_spans_of_the_person_slots(tiny, _preprocessed_f64):
    """A fused step enters the head's span once, with the camera's and the
    queries' spans inside it, and the detection loss's span once."""
    from torch.profiler import ProfilerActivity, profile

    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        _fused_steps(tiny, _host(), _mocap())
    spans = tracing.take()
    names = [s.name for s in spans]
    assert [names.count(n) for n in ("model.head", "model.camera", "model.queries", "gen.detect")] == [1, 1, 1, 1]
    head = names.index("model.head")
    assert all(spans[names.index(n)].parent == head for n in ("model.camera", "model.queries"))


def test_the_predictor_names_the_pair_whose_weights_do_not_fit(tiny):
    _, pcfg, body, hmr_sd, mean, _ = tiny
    bad = {k: v for k, v in hmr_sd.items() if "decexpr" not in k}
    with pytest.raises(RuntimeError, match=r"\(backbone, head\) = \('dinov2_l14', 'hph'\)"):
        Predictor(pcfg, smpl=WM.program_body(body, "cpu"), variables=bad, mean_theta=mean, device="cpu")


# ---------------------------------------------------------------------------
# what the generalisation leaves alone: HMR 2.0's ViT and SMPL, bit for bit


def _vit_before(vit: ViT, images: torch.Tensor, masks) -> torch.Tensor:
    """HMR 2.0's ViT forward as the port wrote it before the options: the
    middle columns, the 16 px patches, ``pos[:, 1:] + pos[:, :1]``, the
    blocks with stochastic depth, the last LayerNorm."""
    x = images[:, :, vit.col0 : images.shape[2] - vit.col0].permute(0, 3, 1, 2)
    x = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
    x = x + vit.pos_embed[:, 1:] + vit.pos_embed[:, :1]
    row = 0
    for b in vit.blocks:
        keep = 1.0 - b.rate
        if masks is not None and b.rate != 0.0:
            am, mm = masks[row], masks[row + 1]
            row += 2
        else:
            am = mm = None
        x = x + drop_path(b.attn(b.norm1(x)), keep, am)
        x = x + drop_path(b.mlp(b.norm2(x)), keep, mm)
    return vit.last_norm(x)


@pytest.mark.parametrize("train", [False, True])
def test_hmr2_vit_gives_the_outputs_it_gave_before(train):
    vit = ViT(64, ViTShape(depth=3, width=32, heads=2, mlp=64))
    vit.reset_parameters(torch.Generator().manual_seed(3))
    vit.train(train)
    cfg = {"vit_depth": 3, "vit_width": 32, "vit_mlp": 64, "img_size": 64}
    assert sorted(vit.state_dict()) == sorted(n[len("encoder."):] for n, _, _ in ref_hmr2.vit_spec(cfg))
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    masks = vit.draw_masks(4, torch.Generator().manual_seed(2))
    assert (masks is not None) == train
    got = vit(x, masks)
    assert got.shape == (4, 12, 32) and torch.equal(got, _vit_before(vit, x, masks))
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    params = list(vit.parameters())
    for a, b in zip(torch.autograd.grad((got * w).sum(), params),
                    torch.autograd.grad((_vit_before(vit, x, masks) * w).sum(), params)):
        assert torch.equal(a, b)


def _smpl_before(model, beta, theta, joint_type, rotations=None):
    """``smpl_forward`` as the port wrote it for SMPL's 24 joints before the
    layout."""
    n, v = beta.shape[0], model.num_verts
    v_shaped = (beta @ model.shapedirs).reshape(n, v, 3) + model.v_template
    joints_rest = torch.einsum("nvc,vk->nkc", v_shaped, model.j_regressor)
    if rotations is None:
        rotations = trot.rodrigues(theta.reshape(n, 24, 3))
    eye = torch.eye(3, dtype=rotations.dtype, device=rotations.device)
    v_posed = ((rotations[:, 1:] - eye).reshape(n, 207) @ model.posedirs).reshape(n, v, 3) + v_shaped
    world_r, world_t = [rotations[:, 0]], [joints_rest[:, 0]]
    for k in range(1, 24):
        p = model.parents[k]
        world_r.append(world_r[p] @ rotations[:, k])
        world_t.append(world_t[p] + (world_r[p] @ (joints_rest[:, k] - joints_rest[:, p])[..., None])[..., 0])
    world_r, world_t = torch.stack(world_r, dim=1), torch.stack(world_t, dim=1)
    skin_t = world_t - (world_r @ joints_rest[..., None])[..., 0]
    blended = model.lbs_weights @ torch.cat([world_r.reshape(n, 24, 9), skin_t], dim=-1)
    verts = (blended[..., :9].reshape(n, v, 3, 3) * v_posed[:, :, None, :]).sum(dim=-1) + blended[..., 9:]
    regressor = model.joint_regressor[:, :14] if joint_type == "lsp" else model.joint_regressor
    return verts, torch.einsum("nvc,vj->njc", verts, regressor), rotations, world_t


@pytest.mark.parametrize("form", ["theta", "rotations"])
def test_smpl_gives_the_outputs_it_gave_before(form):
    model = synthetic_model(num_verts=200, seed=0)
    g = torch.Generator().manual_seed(5)
    beta, theta = torch.randn(6, 10, generator=g), 0.4 * torch.randn(6, 72, generator=g)
    rot = trot.rodrigues(theta.reshape(6, 24, 3)) if form == "rotations" else None
    for joint_type in ("lsp", "cocoplus"):
        got = smpl_forward(model, beta, None if rot is not None else theta, joint_type, rot)
        want = _smpl_before(model, beta, theta, joint_type, rot)
        for a, b in zip((got.verts, got.joints, got.rotations, got.joints_smpl), want):
            assert torch.equal(a, b)
    assert dataclasses.replace(model).layout == model.layout and model.exprdirs is None
    with pytest.raises(ValueError, match="backbone, head"):
        HMR.from_config(model, Config(backbone="dinov2_l14", head="transformer"), device="cpu")
