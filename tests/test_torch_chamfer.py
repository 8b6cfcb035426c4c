"""The port's chamfer forward (ops/cuda_chamfer.py) against the JAX
package: its plain version against the Pallas kernel in interpret mode
(rtol 1e-5: the same direct-form arithmetic, summed in another order) and
against the XLA ``chamfer_loss`` (rtol 2e-4: the expanded-form distances
round differently). Mirrors every value case of test_pallas_chamfer.py.
The CUDA kernel itself runs only on the card (marked ``cuda``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.ops.losses import chamfer_loss
from human_pose_estimation_tpu.ops.pallas_chamfer import _last_active, chamfer_pallas
from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc


def _port(gt, mask, pred, **kw):
    return cc.chamfer_forward_reference(
        torch.from_numpy(np.asarray(gt)), torch.from_numpy(np.asarray(mask)),
        torch.from_numpy(np.asarray(pred)), **kw,
    ).numpy()


@pytest.mark.parametrize("shapes", [(2, 37, 50), (3, 300, 700), (1, 8, 8)])
def test_reference_matches_pallas_and_xla(shapes, rng):
    n, p, v = shapes
    gt = (rng.rand(n, p, 2) * 224).astype(np.float32)
    mask = (rng.rand(n, p) > 0.3).astype(np.float32)
    pred = (rng.rand(n, v, 2) * 224).astype(np.float32)
    pallas = chamfer_pallas(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 64, True)
    xla = chamfer_loss(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), chunk_size=64)
    out = _port(gt, mask, pred, chunk=64)
    np.testing.assert_allclose(out, np.asarray(pallas), rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(xla), rtol=2e-4)


def test_reference_empty_mask(rng):
    gt = (rng.rand(2, 16, 2) * 10).astype(np.float32)
    pred = (rng.rand(2, 12, 2) * 10).astype(np.float32)
    np.testing.assert_array_equal(_port(gt, np.zeros((2, 16), np.float32), pred), np.zeros(2))


def test_reference_identical_sets(rng):
    pts = (rng.rand(2, 20, 2) * 100).astype(np.float32)
    out = _port(pts, np.ones((2, 20), np.float32), pts, chunk=8)
    np.testing.assert_allclose(out, np.zeros(2), atol=1e-2)


def test_tie_break_first_index_value():
    """v0=(3,4) (L1 7) and v1=(5,0) (L1 5) are both exactly d=25 from the
    one gt pixel: the first index wins, 7 + 5 + 5, as in the JAX kernel."""
    gt = np.zeros((1, 8, 2), np.float32)
    mask = np.zeros((1, 8), np.float32)
    mask[0, 0] = 1.0
    pred = np.asarray([[[3.0, 4.0], [5.0, 0.0]]], np.float32)
    pallas = chamfer_pallas(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 8, True)
    np.testing.assert_array_equal(_port(gt, mask, pred), [17.0])
    np.testing.assert_array_equal(_port(gt, mask, pred), np.asarray(pallas))


def test_non_prefix_masks():
    """Valid pixels beyond large masked gaps (an island, a lone last pixel)
    are neither skipped by the last-active count nor by the chunking."""
    rng = np.random.RandomState(11)
    n, p, v = 2, 1024, 33
    gt = rng.rand(n, p, 2).astype(np.float32) * 64
    pred = rng.rand(n, v, 2).astype(np.float32) * 64
    mask = np.zeros((n, p), np.float32)
    mask[0, :17] = 1.0
    mask[0, p - 1] = 1.0
    mask[1, 500:540] = 1.0
    pallas = chamfer_pallas(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 128, True)
    np.testing.assert_allclose(_port(gt, mask, pred, chunk=100), np.asarray(pallas), rtol=1e-5)
    np.testing.assert_array_equal(
        cc.last_active(torch.from_numpy(mask)).numpy(), np.asarray(_last_active(jnp.asarray(mask)))
    )


def test_budget_invariance():
    """A silhouette in a small prefix of a huge budget gives the value of
    the tight budget."""
    rng = np.random.RandomState(12)
    pred = rng.rand(1, 50, 2).astype(np.float32) * 32
    pts_small = rng.rand(1, 256, 2).astype(np.float32) * 32
    mask_small = np.zeros((1, 256), np.float32)
    mask_small[0, :199] = 1.0
    pts_big = np.zeros((1, 4096, 2), np.float32)
    pts_big[:, :256] = pts_small
    mask_big = np.zeros((1, 4096), np.float32)
    mask_big[:, :256] = mask_small
    a = _port(pts_small, mask_small, pred)
    b = _port(pts_big, mask_big, pred)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    pallas = chamfer_pallas(jnp.asarray(pts_big), jnp.asarray(mask_big), jnp.asarray(pred), 128, True)
    np.testing.assert_allclose(b, np.asarray(pallas), rtol=1e-5)


def test_low_precision_inputs_compute_in_f32(rng):
    """bf16 / f16 inputs are cast to f32 first, as the JAX kernel does."""
    gt = torch.from_numpy((rng.rand(2, 40, 2) * 64).astype(np.float32)).bfloat16()
    mask = torch.from_numpy((rng.rand(2, 40) > 0.3).astype(np.float32)).bfloat16()
    pred = torch.from_numpy((rng.rand(2, 30, 2) * 64).astype(np.float32)).half()
    out = cc.chamfer_forward(gt, mask, pred)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), cc.chamfer_forward_reference(gt.float(), mask.float(), pred.float()).numpy()
    )


def test_wrapper_takes_plain_version_on_cpu(rng):
    """CPU tensors go to the plain version, with no launch counted."""
    gt = torch.from_numpy((rng.rand(2, 30, 2) * 50).astype(np.float32))
    mask = torch.from_numpy((rng.rand(2, 30) > 0.4).astype(np.float32))
    pred = torch.from_numpy((rng.rand(2, 25, 2) * 50).astype(np.float32))
    before = cc.LAUNCHES
    np.testing.assert_array_equal(
        cc.chamfer_forward(gt, mask, pred).numpy(), cc.chamfer_forward_reference(gt, mask, pred).numpy()
    )
    assert cc.LAUNCHES == before
    with pytest.raises(ValueError):
        cc.chamfer_forward(gt, mask[:, :5], pred)


def test_cuda_path_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On CUDA tensors the wrapper is forward-only: a pred that requires a
    gradient raises before anything is built, as does a batch larger than
    the launch grid (the device check is patched so that this runs on a
    CPU)."""
    monkeypatch.setattr(cc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(cc, "build", lambda: pytest.fail("must raise before building"))
    pred = torch.zeros(1, 4, 2, requires_grad=True)
    with pytest.raises(NotImplementedError):
        cc.chamfer_forward(torch.zeros(1, 8, 2), torch.ones(1, 8), pred)
    n = cc._MAX_GRID_Y + 1  # more images than the launch grid takes
    with pytest.raises(ValueError, match="images"):
        cc.chamfer_forward(torch.zeros(n, 1, 2), torch.ones(n, 1), torch.zeros(n, 1, 2))


def test_parts_take_plain_version_on_cpu(rng):
    """``chamfer_forward_parts`` on CPU tensors is the plain version's
    (L1, vmin), with no launch counted, and the value is their epilogue."""
    gt = torch.from_numpy((rng.rand(3, 40, 2) * 50).astype(np.float32))
    mask = torch.from_numpy((rng.rand(3, 40) > 0.4).astype(np.float32))
    mask[1] = 0.0
    pred = torch.from_numpy((rng.rand(3, 25, 2) * 50).astype(np.float32))
    before = cc.LAUNCHES
    l1, vmin = cc.chamfer_forward_parts(gt, mask, pred)
    ref_l1, ref_vmin = cc.chamfer_forward_parts_reference(gt, mask, pred)
    assert cc.LAUNCHES == before
    assert torch.equal(l1, ref_l1) and torch.equal(vmin, ref_vmin)
    assert bool((vmin[1] == cc.BIG).all()) and float(l1[1]) == 0.0
    l2 = torch.where(vmin < cc.BIG / 2, vmin.clamp_min(0.0).sqrt(), torch.zeros(())).sum(dim=1)
    np.testing.assert_array_equal(cc.chamfer_forward(gt, mask, pred).numpy(), (l1 + l2).numpy() * [1, 0, 1])


def test_cuda_tensors_never_take_the_plain_forward(monkeypatch):
    """On (patched) CUDA tensors ``chamfer_forward`` and
    ``chamfer_forward_parts`` go to the K1 build, and a failed build raises
    rather than falling back to the plain version."""
    monkeypatch.setattr(cc, "_on_cuda", lambda t: True)
    for plain in ("chamfer_forward_reference", "chamfer_forward_parts_reference", "_epilogue", "last_active"):
        monkeypatch.setattr(cc, plain, lambda *a, **k: pytest.fail("plain version taken"))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cc, "build", no_build)
    args = (torch.zeros(1, 8, 2), torch.ones(1, 8), torch.zeros(1, 4, 2))
    with pytest.raises(RuntimeError, match="nvcc"):
        cc.chamfer_forward(*args)
    with pytest.raises(RuntimeError, match="nvcc"):
        cc.chamfer_forward_parts(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cc, "_lib", None)
    monkeypatch.setattr(cc, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cc.shutil, "which", lambda name: None)
    monkeypatch.setattr(cc, "_NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cc.build()


def _tie_image(first: int, v: int):
    """One image whose one weighted pixel, at (-100, -100), is exactly d=25
    from vertices ``first`` (L1 7) and ``first + 1`` (L1 5) and d=100 from
    the other ``v - 2``: the value is 7 + 10 (v - 2) + 5 + 5 when the first
    vertex wins."""
    gt = np.zeros((1, 8, 2), np.float32)
    gt[0, 0] = [-100.0, -100.0]
    mask = np.zeros((1, 8), np.float32)
    mask[0, 0] = 1.0
    pred = np.tile(np.float32([-90.0, -100.0]), (1, v, 1))
    pred[0, first] = [-97.0, -96.0]
    pred[0, first + 1] = [-95.0, -100.0]
    return (gt, mask, pred), 7.0 + 10.0 * (v - 2) + 10.0


def test_tie_image_values():
    """The tie images of the card test, through the plain version and the
    Pallas kernel in interpret mode: exactly the first vertex's value."""
    for first in (0, 5, 20):
        (gt, mask, pred), want = _tie_image(first, first + 18)
        np.testing.assert_array_equal(_port(gt, mask, pred), [want])
        pallas = chamfer_pallas(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 8, True)
        np.testing.assert_array_equal(np.asarray(pallas), [want])


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(rng):
    """The CUDA kernel against its plain version on the card: vmin bit for
    bit, the L1 and the value up to the order of their sums (rtol 1e-5),
    two runs bit-identical; at a second shape that crosses several pixel
    and vertex chunks of the split passes, with exact ties across the
    library's vertex-chunk boundary and across a group boundary inside a
    chunk, each tie's value exactly the first vertex's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiling = cc.fwd_tiling()
    pc, vc, group = tiling["pixel_chunk"], tiling["vertex_chunk"], tiling["group"]
    n, p, v = 3, 3000, 700
    gt = torch.from_numpy((rng.rand(n, p, 2) * 224).astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.rand(n, p) > 0.3).astype(np.float32)).cuda()
    mask[1] = 0.0
    pred = torch.from_numpy((rng.rand(n, v, 2) * 224).astype(np.float32)).cuda()
    crossing = [
        torch.from_numpy(a).cuda()
        for a in (
            (rng.rand(2, 3 * pc + pc // 3, 2) * 64).astype(np.float32),
            (rng.rand(2, 3 * pc + pc // 3) > 0.3).astype(np.float32),
            (rng.rand(2, 3 * vc + vc // 10, 2) * 64).astype(np.float32),
        )
    ]
    crossing[1][1, : pc + 5] = 0.0  # the first chunks of image 1 are empty
    for case in ((gt, mask, pred), crossing):
        before = cc.LAUNCHES
        out = cc.chamfer_forward(*case)
        l1, vmin = cc.chamfer_forward_parts(*case)
        assert cc.LAUNCHES == before + 2
        ref_l1, ref_vmin = cc.chamfer_forward_parts_reference(*case)
        assert torch.equal(vmin, ref_vmin)
        np.testing.assert_allclose(l1.cpu().numpy(), ref_l1.cpu().numpy(), rtol=1e-5)
        ref = cc.chamfer_forward_reference(*case)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5)
        assert torch.equal(out, cc.chamfer_forward(*case))
        assert torch.equal(vmin, cc.chamfer_forward_parts(*case)[1])
    assert float(cc.chamfer_forward(gt, mask, pred)[1]) == 0.0
    tie = cc.chamfer_forward(
        torch.zeros(1, 8, 2, device="cuda"),
        torch.tensor([[1.0] + [0.0] * 7], device="cuda"),
        torch.tensor([[[3.0, 4.0], [5.0, 0.0]]], device="cuda"),
    )
    assert float(tie[0]) == 17.0
    for first in (vc - 1, vc + group - 1):
        inputs, want = _tie_image(first, first + 2 + group)
        assert float(cc.chamfer_forward(*(torch.from_numpy(a).cuda() for a in inputs))[0]) == want
    with pytest.raises(NotImplementedError):
        cc.chamfer_forward(gt, mask, pred.clone().requires_grad_(True))
