"""The rest of the port's math against the JAX package, in f32 on the CPU
within atol 1e-5: the pose-blendshape feature ``lrotmin``, the geodesic
``rotation_distance``, the mean per-joint error, and the Procrustes
alignment and its error, including inputs whose best orthogonal map is a
reflection (det < 0), which the alignment must not take."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.core import rotations as jrot
from human_pose_estimation_tpu.ops import metrics as jmetrics
from human_pose_estimation_tpu_torch.core import rotations as trot
from human_pose_estimation_tpu_torch.ops import metrics as tmetrics

ATOL = 1e-5


def _close(out, ref, atol=ATOL):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=atol)


def test_lrotmin_matches_jax(rng):
    theta = (rng.randn(5, 72) * 0.6).astype(np.float32)
    theta[0] = 0.0  # the rest pose: all zeros
    out = trot.lrotmin(torch.from_numpy(theta))
    _close(out, jrot.lrotmin(jnp.asarray(theta)))
    assert float(out[0].abs().max()) < 1e-6


def test_rotation_distance_matches_jax(rng):
    a = (rng.randn(6, 3) * 0.8).astype(np.float32)
    b = (rng.randn(6, 3) * 0.8).astype(np.float32)
    b[0] = a[0]  # the same rotation: angle 0 (the clip keeps arccos finite)
    ra, rb = jrot.rodrigues(jnp.asarray(a)), jrot.rodrigues(jnp.asarray(b))
    out = trot.rotation_distance(torch.from_numpy(np.array(ra)), torch.from_numpy(np.array(rb)))
    _close(out, jrot.rotation_distance(ra, rb))
    assert bool(torch.isfinite(out).all()) and float(out[0]) < 1e-3
    # a rotation by a known angle about one axis
    rz = trot.rodrigues(torch.tensor([[0.0, 0.0, 0.7]]))
    assert abs(float(trot.rotation_distance(rz, torch.eye(3)[None])) - 0.7) < 1e-5


def test_mean_per_joint_error_matches_jax(rng):
    kp_gt = rng.randn(4, 14, 3).astype(np.float32)
    kp_gt[..., 2] = (rng.rand(4, 14) > 0.3).astype(np.float32)
    kp_pred = rng.randn(4, 14, 2).astype(np.float32)
    out = tmetrics.mean_per_joint_error(torch.from_numpy(kp_gt), torch.from_numpy(kp_pred))
    _close(out, jmetrics.mean_per_joint_error(jnp.asarray(kp_gt), jnp.asarray(kp_pred)))
    kp_gt[..., 2] = 0.0  # nothing visible: 0, not a division by zero
    assert float(tmetrics.mean_per_joint_error(torch.from_numpy(kp_gt), torch.from_numpy(kp_pred))) == 0.0


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)  # det +1


@pytest.mark.parametrize("reflected", [False, True])
def test_procrustes_and_pa_error_match_jax(rng, reflected):
    """gt = s R pred + t + noise per sample; ``reflected`` mirrors gt
    through a plane, so the unconstrained best map has det < 0."""
    n, p = 5, 24
    pred = rng.randn(n, p, 3).astype(np.float32)
    gt = np.stack([
        1.7 * pred[i] @ _rotation(rng).T + rng.randn(3).astype(np.float32) for i in range(n)
    ]) + 0.05 * rng.randn(n, p, 3).astype(np.float32)
    if reflected:
        gt[..., 0] *= -1.0
    gc, pc = gt - gt.mean(axis=1, keepdims=True), pred - pred.mean(axis=1, keepdims=True)
    u, _, vt = np.linalg.svd(np.einsum("npi,npj->nij", gc, pc))
    assert (np.linalg.det(u @ vt) < 0).all() == reflected  # the guard's case is exercised
    out = tmetrics.procrustes_align(torch.from_numpy(pred), torch.from_numpy(gt))
    _close(out, jmetrics.procrustes_align(jnp.asarray(pred), jnp.asarray(gt)))
    err = tmetrics.pa_error(torch.from_numpy(pred), torch.from_numpy(gt))
    _close(err, jmetrics.pa_error(jnp.asarray(pred), jnp.asarray(gt)))
    if not reflected:  # a similarity plus small noise aligns to the noise level
        assert float(err.max()) < 0.1
    else:  # a mirror is never undone by a rotation
        assert float(err.min()) > 0.1
