"""The port's chamfer value-and-gradient pass (ops/cuda_chamfer.py: K2, K3,
``ChamferFunction``) and its XLA-form ``chamfer_loss`` (ops/losses.py)
against the JAX package.

Tolerances: against the Pallas kernel in interpret mode (the same
direct-form arithmetic) the value is held at rtol 1e-5 (sums taken in
another order), the L1 gradient exactly (binary masks make it an integer
per vertex) and the L2 gradient at atol 1e-6; against ``jax.grad`` of the
expanded-form XLA ``chamfer_loss`` at atol 2e-3, as
test_pallas_chamfer.py holds the Pallas VJP. The CUDA kernels run only on
the card (marked ``cuda``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.ops.losses import chamfer_loss as jchamfer_loss
from human_pose_estimation_tpu.ops.pallas_chamfer import (
    _chamfer_grad_pred_pallas,
    _chamfer_value_and_grad_pallas,
    _run_bwd_kernel,
    chamfer_pallas,
)
from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc
from human_pose_estimation_tpu_torch.ops import losses as tlosses


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _case(rng, n, p, v, scale=224.0, integer_gt=True):
    gt = rng.randint(0, int(scale), (n, p, 2)) if integer_gt else rng.rand(n, p, 2) * scale
    mask = (rng.rand(n, p) > 0.3).astype(np.float32)
    pred = (rng.rand(n, v, 2) * scale).astype(np.float32)
    return gt.astype(np.float32), mask, pred


def _assert_parts_match_pallas(gt, mask, pred, chunk=64, torch_chunk=100):
    l1g, l2g, has_gt, vmin, l1v = _run_bwd_kernel(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), chunk, True, with_value=True
    )
    parts = cc.chamfer_bwd_parts_reference(*_t(gt, mask, pred), chunk=torch_chunk)
    np.testing.assert_array_equal(parts.l1_grad.numpy(), np.asarray(l1g))
    np.testing.assert_allclose(parts.l2_grad.numpy(), np.asarray(l2g), rtol=0, atol=1e-6)
    np.testing.assert_allclose(parts.l1_value.numpy(), np.asarray(l1v), rtol=1e-5)
    value, grad = cc.chamfer_value_and_grad_reference(*_t(gt, mask, pred), chunk=torch_chunk)
    pval, pgrad = _chamfer_value_and_grad_pallas(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), chunk, True)
    np.testing.assert_allclose(value.numpy(), np.asarray(pval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(pgrad), rtol=0, atol=1e-6)
    return value, grad


@pytest.mark.parametrize("shapes", [(2, 37, 50), (3, 300, 700), (1, 8, 8)])
def test_value_and_grad_reference_matches_pallas(shapes, rng):
    n, p, v = shapes
    gt, mask, pred = _case(rng, n, p, v)
    _assert_parts_match_pallas(gt, mask, pred)


def test_grad_reference_matches_pallas_with_cotangent(rng):
    gt, mask, pred = _case(rng, 3, 120, 90)
    ct = rng.rand(3).astype(np.float32) * 3 - 1
    ref = _chamfer_grad_pred_pallas(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), jnp.asarray(ct), chunk_size=32, interpret=True
    )
    out = cc.chamfer_grad_reference(*_t(gt, mask, pred, ct), chunk=50)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6 * float(np.abs(ct).max()))
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(cc.chamfer_grad(*_t(gt, mask, pred, ct)).numpy(), out.numpy())


def test_value_and_grad_match_xla_autodiff(rng):
    """Both plain versions against jax.grad of the XLA chamfer_loss (the
    tolerance of test_pallas_chamfer.py's gradient test)."""
    n, p, v = 2, 45, 30
    gt, mask, pred = _case(rng, n, p, v, scale=100.0, integer_gt=False)
    ref_val = jchamfer_loss(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), chunk_size=16)
    ref_grad = jax.grad(lambda q: jnp.sum(jchamfer_loss(jnp.asarray(gt), jnp.asarray(mask), q, chunk_size=16)))(
        jnp.asarray(pred)
    )
    value, grad = cc.chamfer_value_and_grad_reference(*_t(gt, mask, pred), chunk=16)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_val), rtol=2e-4)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=2e-3)
    k3 = cc.chamfer_grad_reference(*_t(gt, mask, pred, np.ones(n, np.float32)), chunk=16)
    np.testing.assert_allclose(k3.numpy(), np.asarray(ref_grad), atol=2e-3)


def test_tie_value_and_gradient_first_index():
    """v0=(3,4) and v1=(5,0) are both exactly d=25 from the one pixel: the
    value takes the first vertex's L1 (7 + 5 + 5) and only v0 receives the
    pixel's L1 gradient -sign(g - p) = (1, 1)."""
    gt = np.zeros((1, 8, 2), np.float32)
    mask = np.zeros((1, 8), np.float32)
    mask[0, 0] = 1.0
    pred = np.asarray([[[3.0, 4.0], [5.0, 0.0]]], np.float32)
    value, grad = _assert_parts_match_pallas(gt, mask, pred, chunk=8, torch_chunk=8)
    np.testing.assert_array_equal(value.numpy(), [17.0])
    parts = cc.chamfer_bwd_parts_reference(*_t(gt, mask, pred))
    np.testing.assert_array_equal(parts.l1_grad.numpy()[0], [[1.0, 1.0], [0.0, 0.0]])


@pytest.mark.parametrize("second", [1, 9])
def test_tie_gradient_first_pixel_within_and_across_chunks(second):
    """One vertex exactly equidistant from two pixels (indices 0 and
    ``second``; with chunk 8, index 9 lies in the next chunk): the L2
    gradient is the unit vector from the FIRST pixel, total (-2.6, -2.8)."""
    gt = np.zeros((1, 16, 2), np.float32)
    gt[0, 0] = [3.0, 4.0]
    gt[0, second] = [4.0, 3.0]
    mask = np.zeros((1, 16), np.float32)
    mask[0, [0, second]] = 1.0
    pred = np.zeros((1, 1, 2), np.float32)
    _, grad = _assert_parts_match_pallas(gt, mask, pred, chunk=8, torch_chunk=8)
    np.testing.assert_allclose(grad.numpy(), [[[-2.6, -2.8]]], atol=1e-6)


def test_coincident_points_give_finite_zero_l2_gradient(rng):
    pts = rng.randint(0, 100, (2, 20, 2)).astype(np.float32)
    mask = np.ones((2, 20), np.float32)
    parts = cc.chamfer_bwd_parts_reference(*_t(pts, mask, pts), chunk=8)
    assert torch.isfinite(parts.l2_grad).all()
    np.testing.assert_array_equal(parts.l2_grad.numpy(), np.zeros((2, 20, 2)))
    _, grad = cc.chamfer_value_and_grad_reference(*_t(pts, mask, pts), chunk=8)
    assert torch.isfinite(grad).all()


def test_empty_mask_gives_zero_value_and_gradient(rng):
    gt, _, pred = _case(rng, 2, 8, 6, scale=10.0)
    mask = np.zeros((2, 8), np.float32)
    mask[1, :3] = 1.0
    value, grad = _assert_parts_match_pallas(gt, mask, pred, chunk=8, torch_chunk=8)
    assert float(value[0]) == 0.0
    np.testing.assert_array_equal(grad[0].numpy(), np.zeros((6, 2)))
    assert float(value[1]) > 0.0


def test_non_prefix_masks():
    rng = np.random.RandomState(11)
    n, p, v = 2, 1024, 33
    gt = rng.randint(0, 64, (n, p, 2)).astype(np.float32)
    pred = (rng.rand(n, v, 2) * 64).astype(np.float32)
    mask = np.zeros((n, p), np.float32)
    mask[0, :17] = 1.0
    mask[0, p - 1] = 1.0
    mask[1, 500:540] = 1.0
    _assert_parts_match_pallas(gt, mask, pred, chunk=128, torch_chunk=100)


def test_budget_invariance():
    rng = np.random.RandomState(12)
    pred = (rng.rand(1, 50, 2) * 32).astype(np.float32)
    pts_small = rng.randint(0, 32, (1, 256, 2)).astype(np.float32)
    mask_small = np.zeros((1, 256), np.float32)
    mask_small[0, :199] = 1.0
    pts_big = np.zeros((1, 4096, 2), np.float32)
    pts_big[:, :256] = pts_small
    mask_big = np.zeros((1, 4096), np.float32)
    mask_big[:, :256] = mask_small
    a_val, a_grad = cc.chamfer_value_and_grad_reference(*_t(pts_small, mask_small, pred))
    b_val, b_grad = cc.chamfer_value_and_grad_reference(*_t(pts_big, mask_big, pred))
    np.testing.assert_allclose(a_val.numpy(), b_val.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(a_grad.numpy(), b_grad.numpy())
    _assert_parts_match_pallas(pts_big, mask_big, pred, chunk=128, torch_chunk=1024)


def test_chamfer_function_backward_is_cotangent_times_saved_gradient(rng):
    gt, mask, pred = _case(rng, 3, 64, 40)
    g, m, q = _t(gt, mask, pred)
    g.requires_grad_()
    q.requires_grad_()
    ct = torch.from_numpy(rng.rand(3).astype(np.float32))
    value = cc.chamfer(g, m, q)
    (value * ct).sum().backward()
    ref_val, ref_grad = cc.chamfer_value_and_grad_reference(*_t(gt, mask, pred))
    np.testing.assert_array_equal(value.detach().numpy(), ref_val.numpy())
    np.testing.assert_array_equal(q.grad.numpy(), (ct[:, None, None] * ref_grad).numpy())
    assert g.grad is None  # gt and mask get no gradient, as the JAX VJP's zeros
    pallas_grad = jax.grad(
        lambda p: jnp.sum(chamfer_pallas(jnp.asarray(gt), jnp.asarray(mask), p, 32, True) * jnp.asarray(ct.numpy()))
    )(jnp.asarray(pred))
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(pallas_grad), atol=1e-5)


def test_chamfer_function_takes_value_only_path_without_grad(monkeypatch, rng):
    gt, mask, pred = _t(*_case(rng, 2, 30, 20))
    monkeypatch.setattr(cc, "chamfer_value_and_grad", lambda *a: pytest.fail("needs no gradient"))
    with torch.no_grad():
        out = cc.chamfer(gt, mask, pred.requires_grad_())
    np.testing.assert_array_equal(out.numpy(), cc.chamfer_forward_reference(gt, mask, pred.detach()).numpy())
    assert not out.requires_grad


def test_cuda_tensors_never_take_the_plain_version(monkeypatch, rng):
    """On (patched) CUDA tensors the differentiable path goes to the K2
    kernel's build, and a failed build raises rather than falling back."""
    monkeypatch.setattr(cc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(cc, "chamfer_bwd_parts_reference", lambda *a, **k: pytest.fail("plain version taken"))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cc, "build_bwd", no_build)
    gt, mask, pred = _t(*_case(rng, 1, 8, 4))
    with pytest.raises(RuntimeError, match="nvcc"):
        cc.chamfer(gt, mask, pred.requires_grad_())
    with pytest.raises(RuntimeError, match="nvcc"):
        cc.chamfer_grad(gt, mask, pred.detach(), torch.ones(1))


@pytest.mark.parametrize("chunk", [16, 1024])
def test_xla_form_chamfer_loss_matches_jax(chunk, rng):
    """The port's expanded-form ``chamfer_loss`` against the JAX one:
    value rtol 1e-5, gradient atol 1e-5 (the same selections and the same
    autodiff paths), including an empty mask and a coincident vertex."""
    n, p, v = 3, 70, 40
    gt, mask, pred = _case(rng, n, p, v, scale=64.0)
    mask[2] = 0.0
    pred[0, 0] = gt[0, 0]  # sqrt(0) on the pred->gt norm: the double-where keeps it finite
    mask[0, 0] = 1.0
    ref = jchamfer_loss(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), chunk_size=chunk)
    ref_grad = jax.grad(lambda q: jnp.sum(jchamfer_loss(jnp.asarray(gt), jnp.asarray(mask), q, chunk_size=chunk)))(
        jnp.asarray(pred)
    )
    q = torch.from_numpy(pred).requires_grad_()
    out = tlosses.chamfer_loss(*_t(gt, mask), q, chunk_size=chunk)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(ref_grad), atol=1e-5)
    assert torch.isfinite(q.grad).all()
    # and mesh_reprojection_loss(impl='xla') is it, scaled
    mr = tlosses.mesh_reprojection_loss(*_t(gt, mask, pred), impl="xla")
    np.testing.assert_allclose(float(mr), float(np.asarray(ref).sum() / (3.0 + v)), rtol=1e-5)


def _chunk_crossing_case(rng, pixel_chunk, vertex_chunk, group):
    """Two images of 2.3 pixel chunks and 2.1 vertex chunks, with an exact
    tie on each side of a chunk boundary: pixel 0 of image 0 is d=25 from
    vertices vc-1 and vc, and vertex 0 of image 1 is d=25 from pixels
    pc-1 and pc; on each side of a group boundary inside a chunk: pixel 1
    of image 0 is d=25 from vertices vc+group-1 and vc+group, and vertex 2
    of image 1 from pixels pc+group-1 and pc+group; and vertex 1 of image
    1 is d=25 from pixels pc+1 and pc+2, inside one group."""
    p, v = 2 * pixel_chunk + pixel_chunk // 3, 2 * vertex_chunk + vertex_chunk // 10
    gt, mask, pred = _case(rng, 2, p, v)
    vc, pc = vertex_chunk, pixel_chunk
    gt[0, 0], mask[0, 0] = [-100.0, -100.0], 1.0
    pred[0, vc - 1], pred[0, vc] = [-97.0, -96.0], [-95.0, -100.0]
    gt[1, pc - 1], gt[1, pc] = [503.0, 504.0], [504.0, 503.0]
    mask[1, [pc - 1, pc]] = 1.0
    pred[1, 0] = [500.0, 500.0]
    gt[1, pc + 1], gt[1, pc + 2] = [703.0, 704.0], [704.0, 703.0]
    mask[1, [pc + 1, pc + 2]] = 1.0
    pred[1, 1] = [700.0, 700.0]
    gt[0, 1], mask[0, 1] = [-500.0, 500.0], 1.0
    pred[0, vc + group - 1], pred[0, vc + group] = [-497.0, 504.0], [-495.0, 500.0]
    gt[1, pc + group - 1], gt[1, pc + group] = [903.0, 904.0], [904.0, 903.0]
    mask[1, [pc + group - 1, pc + group]] = 1.0
    pred[1, 2] = [900.0, 900.0]
    return gt, mask, pred


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(rng):
    """K2, K3 and K4 against the plain version on the card: L1 gradient
    exact, L2 gradient atol 1e-6, vmin bit-equal, value rtol 1e-5,
    bit-repeatable; at a second shape that crosses several pixel and
    vertex chunks of the split passes, the ties that straddle chunk and
    group boundaries go to the first index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiling = cc.bwd_tiling()
    vc, group = tiling["vertex_chunk"], tiling["group"]
    crossing = _chunk_crossing_case(rng, tiling["pixel_chunk"], vc, group)
    for case in (_case(rng, 3, 3000, 700), crossing):
        gt, mask, pred = (t.cuda() for t in _t(*case))
        if case is not crossing:
            mask[1] = 0.0
        ref = cc.chamfer_bwd_parts_reference(gt, mask, pred)
        for f32_index in (False, True):
            out = cc.chamfer_bwd_parts(gt, mask, pred, with_value=True, f32_index=f32_index)
            again = cc.chamfer_bwd_parts(gt, mask, pred, with_value=True, f32_index=f32_index)
            assert torch.equal(out.l1_grad, ref.l1_grad)
            assert torch.equal(out.vmin, ref.vmin)
            assert float((out.l2_grad - ref.l2_grad).abs().max()) <= 1e-6
            np.testing.assert_allclose(out.l1_value.cpu().numpy(), ref.l1_value.cpu().numpy(), rtol=1e-5)
            for a, b in zip(out, again):
                assert torch.equal(a, b)
        k3 = cc.chamfer_bwd_parts(gt, mask, pred, with_value=False)
        assert k3.l1_value is None and torch.equal(k3.l1_grad, ref.l1_grad)
    for first in (vc - 1, vc + group - 1):
        assert out.l1_grad[0, first].tolist() == [1.0, 1.0] and out.l1_grad[0, first + 1].tolist() == [0.0, 0.0]
    for vert in (0, 1, 2):
        assert out.l1_grad[1, vert].tolist() == [-2.0, -2.0]
        np.testing.assert_allclose(out.l2_grad[1, vert].cpu().numpy(), [-0.6, -0.8], rtol=0, atol=1e-6)
    q = pred.clone().requires_grad_()
    before = cc.VALUE_GRAD_LAUNCHES
    cc.chamfer(gt, mask, q).sum().backward()
    assert cc.VALUE_GRAD_LAUNCHES == before + 1
