"""The port's models against the JAX package's on bridged weights, in f32
on the CPU at a small size (a (1,1,1,1) encoder at 64 px, the 120-vertex
asset): the weight bridge, ResNet features, the IEF regressor, the critic,
KCS and the HMR forward. Tolerance: 1e-4 relative to the largest magnitude
of each compared array (convolution and matmul sums are taken in another
order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.models.critic import Critic as JCritic
from human_pose_estimation_tpu.models.hmr import HMR as JHMR
from human_pose_estimation_tpu.models.regressor import THETA_DIM
from human_pose_estimation_tpu.ops import kcs as jkcs
from human_pose_estimation_tpu.utils.assets import synthetic_mean_params
from human_pose_estimation_tpu_torch.models import port_jax
from human_pose_estimation_tpu_torch.models.critic import Critic
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.ops import kcs as tkcs
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

IMG = 64
RTOL = 1e-4


def assert_rel(out, ref, rtol=RTOL, name=""):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()), err_msg=name)


@pytest.fixture(scope="module")
def models(tiny_model):
    jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=(1, 1, 1, 1))
    variables = jhmr.init(jax.random.PRNGKey(0), img_size=IMG)
    # non-trivial BN statistics, so that the bridge's mean/var mapping counts
    rng = np.random.RandomState(5)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, np.shape(a)).astype(np.float32),
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    vnp = jax.tree.map(np.asarray, variables)
    thmr = HMR(
        synthetic_model(num_verts=120, seed=0), num_stage=3, joint_type="lsp",
        encoder_stage_sizes=(1, 1, 1, 1), device="cpu",
    )
    thmr.load_state_dict(port_jax.hmr_state_dict(vnp))
    return jhmr, variables, thmr


def _images(rng, n=3):
    return (rng.rand(n, IMG, IMG, 3) * 2 - 1).astype(np.float32)


def test_bridge_covers_every_tensor(models):
    jhmr, variables, thmr = models
    sd = port_jax.hmr_state_dict(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(thmr.state_dict())
    n_jax = sum(np.size(a) for a in jax.tree.leaves(variables))
    n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    assert sum(t.numel() for t in sd.values()) == n_jax + n_bn


def test_bridge_fits_full_resnet50(tiny_model):
    """The bridge's names and layouts fit the full ResNet-50 encoder (from
    the shapes of the JAX init; nothing is compiled)."""
    jhmr = JHMR(tiny_model)
    shapes = jax.eval_shape(lambda k: jhmr.init(k, img_size=IMG), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    thmr = HMR(synthetic_model(num_verts=30), device="cpu")
    thmr.load_state_dict(port_jax.hmr_state_dict(zeros))  # strict
    assert thmr.encoder.feature_dim == 2048


def test_resnet_features_match_jax(models, rng):
    jhmr, variables, thmr = models
    images = _images(rng)
    enc_vars = {"params": variables["params"]["encoder"], "batch_stats": variables["batch_stats"]["encoder"]}
    ref = jhmr.encoder.apply(enc_vars, jnp.asarray(images), train=False)
    with torch.no_grad():
        out = thmr.encoder(torch.from_numpy(images))
    assert_rel(out, ref, name="features")


def test_regressor_matches_jax(models, rng):
    jhmr, variables, thmr = models
    feat = rng.randn(4, thmr.encoder.feature_dim).astype(np.float32)
    theta = rng.randn(4, THETA_DIM).astype(np.float32)
    ref = jhmr.regressor.apply(
        {"params": variables["params"]["regressor"]}, jnp.asarray(feat), jnp.asarray(theta), train=False
    )
    with torch.no_grad():
        out = thmr.regressor(torch.from_numpy(feat), torch.from_numpy(theta))
    assert_rel(out, ref, name="delta theta")


def test_critic_and_kcs_match_jax(rng):
    jc = JCritic()
    n = 5
    joints = rng.randn(n, 19, 3).astype(np.float32)
    c = jkcs.bone_incidence_matrix()
    np.testing.assert_array_equal(tkcs.bone_incidence_matrix(), c)
    kcs_ref = jkcs.kcs(jnp.asarray(joints), jnp.asarray(c))
    kcs_out = tkcs.kcs(torch.from_numpy(joints), torch.from_numpy(c))
    assert_rel(kcs_out, kcs_ref, name="kcs")
    assert_rel(
        tkcs.bone_lengths_sq(torch.from_numpy(joints), torch.from_numpy(c)),
        jkcs.bone_lengths_sq(jnp.asarray(joints), jnp.asarray(c)),
        name="bone lengths",
    )
    shapes = rng.randn(n, 10).astype(np.float32)
    rots = rng.randn(n, 23, 3, 3).astype(np.float32)
    args = (np.array(kcs_ref), np.ascontiguousarray(joints[:, :14]), shapes, rots)
    params = jc.init(jax.random.PRNGKey(3), *map(jnp.asarray, args))["params"]
    ref = jc.apply({"params": params}, *map(jnp.asarray, args))
    critic = Critic()
    critic.load_state_dict(port_jax.flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = critic(*map(torch.from_numpy, args))
    assert_rel(out, ref, name="critic scores")


@pytest.mark.parametrize("smpl_stages", ["all", "last"])
def test_hmr_forward_matches_jax(models, smpl_stages, rng):
    jhmr, variables, thmr = models
    images = _images(rng)
    mean = synthetic_mean_params()[None]
    ref, _ = jhmr(variables, jnp.asarray(images), jnp.asarray(mean), train=False, smpl_stages=smpl_stages)
    with torch.no_grad():
        out = thmr(torch.from_numpy(images), port_jax.mean_theta(mean), smpl_stages=smpl_stages)
    assert len(out) == len(ref) == 3
    for i, (o, r) in enumerate(zip(out, ref)):
        for name in ("theta", "cam", "pose", "shape", "verts", "joints3d", "rotations", "kp2d"):
            if getattr(r, name) is None:
                assert getattr(o, name) is None, (i, name)
            else:
                assert_rel(getattr(o, name), getattr(r, name), name=f"stage {i} {name}")
    if smpl_stages == "all":
        assert out[0].rotations.shape == (3, 23, 3, 3)


def test_hmr_bf16_encoder_close_to_f32(models, rng):
    """encoder_dtype='bfloat16' runs the encoder and regressor under
    autocast; the outputs stay within bf16 rounding (2e-2 relative) of the
    f32 forward and come out in f32."""
    _, variables, thmr = models
    bf16 = HMR(
        synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=(1, 1, 1, 1),
        encoder_dtype="bfloat16", device="cpu",
    )
    bf16.load_state_dict(thmr.state_dict())
    images = torch.from_numpy(_images(rng))
    mean = port_jax.mean_theta(synthetic_mean_params())
    with torch.no_grad():
        ref = thmr(images, mean)[-1]
        out = bf16(images, mean)[-1]
    assert out.verts.dtype == torch.float32
    assert bf16.encoder.conv1.weight.dtype == torch.float32
    assert_rel(out.theta, ref.theta.numpy(), rtol=2e-2, name="theta")
    assert_rel(out.verts, ref.verts.numpy(), rtol=2e-2, name="verts")


def test_hmr_refuses_unported_paths(models):
    _, _, thmr = models
    images = torch.zeros(1, IMG, IMG, 3)
    mean = torch.zeros(1, 85)
    with pytest.raises(ValueError, match="inference-only"):  # int8 is an eval-mode path
        thmr.train()
        try:
            thmr(images, mean, encoder_qparams=thmr.quantize_encoder(), generator=torch.Generator())
        finally:
            thmr.eval()
    with pytest.raises(ValueError):
        thmr(images, mean, smpl_stages="first")
    thmr.train()
    try:  # train-mode dropout draws from an explicit generator only
        with pytest.raises(ValueError, match="Generator"):
            thmr(images, mean)
    finally:
        thmr.eval()
