"""The plain reference at a tiny size: against itself and a brute-force
chamfer, and against the port computing in float32 through the cells' own
paths on the CPU (the same arithmetic, so the gaps are rounding)."""
import numpy as np
import pytest
import torch

from conftest import run_tiny
from portbench import harness as H
from portbench import traffic
from portbench import weights as W
from portbench.reference import augment, losses, model
from portbench.reference import train as ref_train


def test_chamfer_against_brute_force():
    g = torch.Generator().manual_seed(0)
    gt = torch.randint(0, 32, (3, 40, 2), generator=g).float()
    mask = (torch.arange(40)[None] < torch.tensor([[25], [0], [40]])).float()
    pred = torch.rand(3, 17, 2, generator=g) * 32
    got = losses.chamfer(gt, mask, pred, chunk=7)
    for b in range(3):
        m = mask[b] > 0
        if not m.any():
            assert got[b] == 0
            continue
        d = ((gt[b][:, None] - pred[b][None]) ** 2).sum(-1).numpy()
        near = d.argmin(1)
        l1 = (np.abs(gt[b].numpy() - pred[b].numpy()[near]).sum(1) * mask[b].numpy()).sum()
        l2 = np.sqrt(d[m.numpy()].min(0)).sum()
        assert float(got[b]) == pytest.approx(l1 + l2, rel=1e-5)


def test_train_step_repeats_and_moves():
    cfg = {**H.cell(H.benchmark(), "hybrid-train-b8")[1], "encoder_stage_sizes": [1, 1, 1, 1], "img_size": 64, "num_verts": 100, "max_silhouette_points": 128,
        "batch_size": 2}
    dev = torch.device("cpu")

    def once():
        p, mean = W.make_hmr(cfg, 3, dev)
        state = ref_train.State({**{k: v for k, v in p.items() if "running" not in k and "num_batches" not in k},
                                 "mean_theta": mean}, {k: v for k, v in p.items() if "running" in k},
                                W.make_critic(cfg, 3, dev), ref_train.Adam(1e-4), ref_train.Adam(5e-4))
        host = traffic.canvases(traffic.rng(3, 1), 1, 2, 256)[0]
        pose, shape = traffic.mocap(traffic.rng(3, 2), 1, 6)[0]
        out = ref_train.train_step(state, W.make_body(cfg, 3, dev), cfg, {k: torch.from_numpy(v) for k, v in host.items()},
                                   (torch.from_numpy(pose), torch.from_numpy(shape)), ref_train.step_generator(4, 0, dev))
        return out, state, p

    a, sa, p = once()
    b, sb, _ = once()
    assert all(torch.equal(a[k], b[k]) for k in ("kpr_losses", "mr_losses", "generator_loss", "critic_loss"))
    assert all(torch.isfinite(a[k]).all() for k in ("kpr_losses", "mr_losses", "critic_penalty"))
    fresh, _ = W.make_hmr(cfg, 3, torch.device("cpu"))
    assert not torch.equal(sa.gen["regressor.fc1.weight"], fresh["regressor.fc1.weight"])  # Adam moved it


def test_silhouette_order_and_centre_crop():
    seg = torch.zeros(1, 16, 16, 1)
    seg[0, 3:6, 4:9] = 1.0
    pts, mask = augment.silhouette(seg, 40)
    assert int(mask.sum()) == 15 and mask[0, :15].all()
    keys = [((int(y) * 16 + int(x)) * 40503) & 0xFFFF for x, y in pts[0, :15]]
    assert keys == sorted(keys)
    h = traffic.canvases(traffic.rng(0, 1), 1, 2, 256)[0]
    out = augment.prepare({k: torch.from_numpy(v) for k, v in h.items()},
                          {"img_size": 224, "max_silhouette_points": 16384}, augment=False)
    assert out.images.shape == (2, 224, 224, 3) and float(out.images.abs().max()) <= 1.0
    assert 2000 < int(out.seg_mask[0].sum()) < 9000


def test_body_model_rest_pose():
    cfg = {"num_verts": 50, "num_betas": 10}
    body = W.make_body(cfg, 0, torch.device("cpu"))
    verts, joints, rot = model.smpl(body, torch.zeros(1, 10), torch.zeros(1, 72), "lsp")
    assert torch.allclose(verts[0], body.v_template, atol=1e-5)  # the rest pose is the template
    assert joints.shape == (1, 14, 3) and torch.allclose(rot, torch.eye(3).expand(1, 24, 3, 3), atol=1e-6)


@pytest.mark.parametrize("cell,bounds", [
    ("hybrid-train-b8", {"loss_gap": 1e-4, "mr1_gap": 1e-4, "grad1_gap": 1e-4, "change_gap": 5e-2}),
])
def test_the_port_in_float32_matches_the_reference(cell, bounds):
    line, notes = run_tiny(cell, encoder_dtype="float32")
    numbers = notes["all numbers"]
    for k, v in bounds.items():
        assert numbers[k] < v, (k, numbers[k])
    assert line["correct"] and line["attempted"] > 0
