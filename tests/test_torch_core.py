"""The port's core (rotations, SMPL, projection, assets, mean params)
against the JAX package on the same numpy inputs, in f32 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.core import projection as jproj
from human_pose_estimation_tpu.core import rotations as jrot
from human_pose_estimation_tpu.core import smpl as jsmpl
from human_pose_estimation_tpu.utils import assets as jassets
from human_pose_estimation_tpu.utils import mean_params as jmean
from human_pose_estimation_tpu_torch.core import projection as tproj
from human_pose_estimation_tpu_torch.core import rotations as trot
from human_pose_estimation_tpu_torch.core import smpl as tsmpl
from human_pose_estimation_tpu_torch.utils import assets as tassets
from human_pose_estimation_tpu_torch.utils import mean_params as tmean

FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "joint_regressor")


def _same_model(jm, tm):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)
    assert tm.parents == tuple(jm.parents)
    np.testing.assert_array_equal(tm.faces, jm.faces)


@pytest.fixture(scope="module")
def port_full_model():
    return tassets.synthetic_model(num_verts=6890, seed=0)


@pytest.mark.parametrize("num_verts,seed", [(120, 0), (257, 3)])
def test_synthetic_model_same_arrays(num_verts, seed):
    """The same seed gives the same asset arrays in both packages."""
    _same_model(jassets.synthetic_model(num_verts, seed), tassets.synthetic_model(num_verts, seed))


def test_synthetic_mean_params_and_mean_theta(tmp_path):
    np.testing.assert_array_equal(tassets.synthetic_mean_params(3), jassets.synthetic_mean_params(3))
    np.testing.assert_array_equal(tmean.load_mean_theta(""), jmean.load_mean_theta(""))
    rng = np.random.RandomState(0)
    path = str(tmp_path / "mean.npz")
    np.savez(path, pose=rng.randn(72).astype(np.float32), shape=rng.randn(10).astype(np.float32))
    np.testing.assert_array_equal(tmean.load_mean_theta(path), jmean.load_mean_theta(path))


def test_model_loaders_read_jax_written_assets(tmp_path, tiny_model):
    """npz and the official pickle layout, written by the JAX package,
    load into the same arrays with the port's numpy loaders."""
    npz = str(tmp_path / "model.npz")
    pkl = str(tmp_path / "model.pkl")
    jsmpl.save_model_npz(tiny_model, npz)
    jassets.write_reference_pickle(tiny_model, pkl)
    _same_model(tiny_model, tsmpl.load_model(npz))
    loaded = tsmpl.load_model(pkl)
    for k in FIELDS:  # the pickle stores f64 and transposed layouts
        np.testing.assert_allclose(getattr(loaded, k).numpy(), np.asarray(getattr(tiny_model, k)), atol=0)
    assert loaded.parents == tuple(tiny_model.parents)


def test_rodrigues_matches_jax(rng):
    theta = (rng.randn(64, 3) * 1.5).astype(np.float32)
    theta[:4] = 0.0  # the zero rotation goes through the epsilon
    ref = np.asarray(jrot.rodrigues(jnp.asarray(theta), eps_mode="reference"))
    out = trot.rodrigues(torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)  # f32 elementwise math
    np.testing.assert_array_equal(
        trot.skew(torch.from_numpy(theta)).numpy(), np.asarray(jrot.skew(jnp.asarray(theta)))
    )


@pytest.mark.parametrize("joint_type", ["lsp", "cocoplus"])
def test_smpl_forward_matches_jax_full_model(joint_type, full_model, port_full_model, rng):
    """Verts and joints agree to 1e-5 absolute in f32 on the 6890-vertex
    asset (sums over 6890 vertices are taken in another order)."""
    beta = rng.randn(4, 10).astype(np.float32)
    theta = (0.5 * rng.randn(4, 72)).astype(np.float32)
    ref = jsmpl.smpl_forward(full_model, jnp.asarray(beta), jnp.asarray(theta), joint_type=joint_type)
    out = tsmpl.smpl_forward(
        port_full_model, torch.from_numpy(beta), torch.from_numpy(theta), joint_type=joint_type
    )
    for name in ("verts", "joints", "joints_smpl", "rotations"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-5, err_msg=name
        )
    assert out.joints.shape == (4, 14 if joint_type == "lsp" else 19, 3)


def test_smpl_forward_rejects_unknown_joint_type():
    m = tassets.synthetic_model(num_verts=30)
    with pytest.raises(ValueError):
        tsmpl.smpl_forward(m, torch.zeros(1, 10), torch.zeros(1, 72), joint_type="h36m")


def test_projection_matches_jax(rng):
    pts = rng.randn(3, 50, 3).astype(np.float32)
    cam = rng.randn(3, 3).astype(np.float32)
    np.testing.assert_allclose(
        tproj.orth_project(torch.from_numpy(pts), torch.from_numpy(cam)).numpy(),
        np.asarray(jproj.orth_project(jnp.asarray(pts), jnp.asarray(cam))),
        atol=1e-6,
    )
    for size in (224.0, [200.0, 180.0]):
        np.testing.assert_allclose(
            tproj.reproject_to_pixels(torch.from_numpy(pts), torch.from_numpy(cam), size).numpy(),
            np.asarray(jproj.reproject_to_pixels(jnp.asarray(pts), jnp.asarray(cam), size)),
            rtol=1e-6,
            atol=1e-4,
        )
