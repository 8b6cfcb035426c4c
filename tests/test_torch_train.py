"""The port's training slice against the JAX package, in f32 on the CPU at a
small size (a (1,1,1,1) encoder at 56 px, the 120-vertex asset, batch 8,
32 silhouette pixels at integer coordinates, 24 mocap samples):
BatchNorm's train mode, train-mode dropout, the optimizers and their
schedules, the gradient penalty, the training-state bridge, and one whole
``make_train_step`` from one bridged state.

Tolerances are stated per test. The whole step is held at 1e-4 relative
for every ``StepMetrics`` field and the new BN statistics, and its
gradients (SGD with rate 1, so ``before - after`` is the gradient, the
penalty's double backward included) within 1e-3 of each leaf's largest
magnitude (at least 1e-5 of the largest gradient): the JAX step takes the chamfer through the
expanded-form XLA ``chamfer_loss`` and autodiff, the port through the plain
version of K2, and the JAX step runs in f64 (see ``step_pair``).

The same step on two gloo ranks of 4 rows each (``two_rank_steps``, worker
``tests/torch_dp_worker.py``) is held against the JAX step in f32 with
those tolerances, in both ``gp_mode``s, and against the port's
one-process step in f64 at 1e-9.
"""
import copy

import numpy as np
import optax
import pytest
import torch
from torch.optim.lr_scheduler import LambdaLR

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.core.rotations import rodrigues as jrodrigues
from human_pose_estimation_tpu.models.critic import Critic as JCritic
from human_pose_estimation_tpu.models.hmr import HMR as JHMR
from human_pose_estimation_tpu.models.regressor import IEFRegressor as JIEFRegressor
from human_pose_estimation_tpu.ops import losses as jlosses
from human_pose_estimation_tpu.train import state as jstate
from human_pose_estimation_tpu.train import step as jstep
from human_pose_estimation_tpu.utils.assets import synthetic_mean_params as jmean_params
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.models import port_jax
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.ops import losses as tlosses
from human_pose_estimation_tpu_torch.train import step as tstep
from human_pose_estimation_tpu_torch.train.state import TrainState, create_train_state, make_optimizers
from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

import torch_dp_worker as dp_worker  # tests/torch_dp_worker.py: the 2-rank gloo worker

IMG = 56
BATCH = 8
NSIL = 32
MOCAP = 3 * BATCH
STAGES = (1, 1, 1, 1)
METRICS = (
    "kpr_losses", "mr_losses", "gen_critic_losses", "generator_loss", "critic_loss",
    "critic_penalty", "bone_length_pred", "bone_length_gt",
)


def assert_rel(out, ref, rtol, name=""):
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()), err_msg=name)


def _cfg(**kw):
    base = dict(img_size=IMG, batch_size=BATCH, use_mesh_repro_loss=True, encoder_dtype="float32")
    base.update(kw)
    return base


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.rand(BATCH, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    seg_points = rng.randint(0, IMG, (BATCH, NSIL, 2)).astype(np.float32)
    seg_mask = np.zeros((BATCH, NSIL), np.float32)
    for b, c in enumerate([32, 20, 0, 12, 32, 5, 31, 17]):  # prefix silhouettes, one empty
        seg_mask[b, :c] = 1.0
    kp2d = (rng.rand(BATCH, 19, 3) * 2 - 1).astype(np.float32)
    kp2d[..., 2] = (rng.rand(BATCH, 19) > 0.2).astype(np.float32)
    joints = (rng.randn(MOCAP, 14, 3) * 0.3).astype(np.float32)
    shapes = (rng.randn(MOCAP, 10) * 0.3).astype(np.float32)
    rots = np.asarray(jrodrigues(jnp.asarray(rng.randn(MOCAP, 23, 3).astype(np.float32) * 0.4)))
    return (images, seg_points, seg_mask, kp2d), (joints, shapes, rots)


def _torch_batch(arrays):
    gen, mocap = arrays
    to_t = lambda a: torch.from_numpy(np.array(a))
    return tstep.GenBatch(*map(to_t, gen)), tstep.MocapBatch(*map(to_t, mocap))


@pytest.fixture(scope="module")
def jax_setup(tiny_model):
    jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=STAGES)
    # rate 0: Flax's Dropout returns its input, so both sides are deterministic
    jhmr.regressor = JIEFRegressor(dropout_rate=0.0, compute_dtype=jnp.float32)
    jcritic = JCritic()
    state = jstate.create_train_state(
        jax.random.PRNGKey(0), jhmr, jcritic, jmean_params()[None, :], 1e-4, 5e-4, img_size=IMG
    )
    return jhmr, jcritic, state


def _torch_state(cfg: Config, state_np=None, sgd=False, dropout_rate=0.5) -> TrainState:
    ts = create_train_state(synthetic_model(num_verts=120, seed=0), synthetic_mean_params(), cfg, device="cpu")
    ts.hmr.regressor.dropout_rate = dropout_rate
    if sgd:
        ts.gen_opt = torch.optim.SGD(ts.gen_params(), lr=1.0)
        ts.critic_opt = torch.optim.SGD(list(ts.critic.parameters()), lr=1.0)
        ts.gen_sched = LambdaLR(ts.gen_opt, lambda count: 1.0)
        ts.critic_sched = LambdaLR(ts.critic_opt, lambda count: 1.0)
    if state_np is None:
        return ts
    if sgd:  # the weights only: SGD has no state to bridge
        gen = state_np.gen_params
        ts.hmr.load_state_dict(port_jax.hmr_state_dict(
            {"params": {k: gen[k] for k in ("encoder", "regressor")}, "batch_stats": state_np.batch_stats}
        ))
        ts.critic.load_state_dict(port_jax.flax_to_state_dict(state_np.critic_params))
        with torch.no_grad():
            ts.mean_theta.copy_(port_jax.mean_theta(gen["mean_theta"]))
    else:
        ts.load_state_dict(port_jax.train_state_from_jax(state_np))
    return ts


def _snapshot(ts: TrainState):
    named = dict(port_jax_names(ts))
    return {k: v.detach().clone() for k, v in named.items()}


def port_jax_names(ts: TrainState):
    """Every trainable tensor of the torch state under its bridge name."""
    for name, p in ts.hmr.named_parameters():
        yield name, p
    yield "mean_theta", ts.mean_theta
    for name, p in ts.critic.named_parameters():
        yield f"critic.{name}", p


@pytest.fixture(scope="module")
def step_pair(jax_setup, tiny_model):
    """One JAX train step with SGD(1) from the fixture's state, run in f64
    (``jax.enable_x64``), and the GP uniforms it drew. The f64 run is the
    oracle because JAX's own f32 gradient of the train-mode encoder on the
    CPU is ~1e-3 off its f64 value at this size, while the port's f32
    gradient is within 1e-5 of the port in f64."""
    return _jax_step(jax_setup, tiny_model)


@pytest.fixture(scope="module")
def step_pair_per_sample(jax_setup, tiny_model):
    """``step_pair`` with ``gp_mode='per_sample'`` (the same state, batch,
    key and so the same uniforms)."""
    return _jax_step(jax_setup, tiny_model, gp_mode="per_sample")


def _jax_step(jax_setup, tiny_model, **cfg):
    _, _, state = jax_setup
    f64 = jnp.float64
    with jax.enable_x64(True):
        jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=STAGES, encoder_dtype=f64)
        # rate 0: Flax's Dropout returns its input, so both sides are deterministic
        jhmr.regressor = JIEFRegressor(dropout_rate=0.0, compute_dtype=f64)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jstep, "make_optimizers", lambda *a, **k: (optax.sgd(1.0), optax.sgd(1.0)))
            fn = jax.jit(jstep.make_train_step(jhmr, JCritic(compute_dtype=f64), JConfig(**_cfg(**cfg))))
        wide = lambda t: jax.tree.map(
            lambda a: jnp.asarray(a, f64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, t
        )
        state = wide(state.replace(gen_opt=(), critic_opt=()))
        state = state.replace(
            gen_opt=optax.sgd(1.0).init(state.gen_params), critic_opt=optax.sgd(1.0).init(state.critic_params)
        )
        arrays = _arrays(0)
        gen, mocap = arrays
        key = jax.random.PRNGKey(1)
        new_state, metrics = fn(
            state, jstep.GenBatch(*map(wide, gen)), jstep.MocapBatch(*map(wide, mocap)), key
        )
        # the uniforms train_step draws: fold_in(rng, step) -> split -> split in 3
        _, gp_rng = jax.random.split(jax.random.fold_in(key, state.step))
        ra, rb, rc = jax.random.split(gp_rng, 3)
        uniforms = [
            np.asarray(jax.random.uniform(r, s), np.float32)
            for r, s in ((ra, (MOCAP, 14, 3)), (rb, (MOCAP, 10)), (rc, (MOCAP, 23, 3, 3)))
        ]
        to_np = lambda t: jax.tree.map(np.asarray, t)
        return to_np(state), to_np(new_state), to_np(metrics), arrays, uniforms


def _jax_grads(before, after):
    """{bridge name: before - after} of the generator and critic trees."""
    diff = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), before.gen_params, after.gen_params)
    out = {k: v.numpy() for k, v in port_jax._gen_tree_to_torch(diff).items()}
    cdiff = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), before.critic_params, after.critic_params)
    out.update({f"critic.{k}": v.numpy() for k, v in port_jax.flax_to_state_dict(cdiff).items()})
    return out


def _assert_matches_jax(step_pair, metrics, hmr_sd, grads):
    """A step's ``metrics`` (field -> array), new HMR state dict and
    gradients (bridge name -> before - after under SGD(1)) against the JAX
    f64 step of ``step_pair``: metrics and BN statistics at 1e-4 relative,
    gradients within 1e-3 of each leaf's largest magnitude."""
    state_np, new_np, metrics_np, _, _ = step_pair
    for name in METRICS:
        assert_rel(metrics[name], getattr(metrics_np, name), 1e-4, name)
    assert float(metrics["critic_penalty"]) > 0.0 and (np.asarray(metrics["mr_losses"]) > 0).all()

    new_sd = port_jax.hmr_state_dict(
        {"params": {k: new_np.gen_params[k] for k in ("encoder", "regressor")}, "batch_stats": new_np.batch_stats}
    )
    stats = [k for k in new_sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert_rel(hmr_sd[k], new_sd[k].numpy(), 1e-4, k)

    ref = _jax_grads(state_np, new_np)
    assert set(ref) <= set(grads)
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for k, g_ref in ref.items():
        g = np.asarray(grads[k])
        # the conv biases before a BN have an exact zero gradient (BN takes
        # the mean out): both sides hold only rounding there, hence a floor
        # of 1e-5 of the largest gradient of all
        tol = max(1e-3 * float(np.abs(g_ref).max()), 1e-5 * scale)
        assert g.shape == g_ref.shape, k
        assert float(np.abs(g - g_ref).max()) <= tol, (k, float(np.abs(g - g_ref).max()), tol)
    assert float(np.abs(ref["critic.kcs_dense.weight"]).max()) > 0  # the critic did train


def test_train_step_matches_jax(step_pair, monkeypatch):
    state_np, new_np, metrics_np, arrays, uniforms = step_pair
    cfg = Config(encoder_stage_sizes="1,1,1,1", **_cfg())
    ts = _torch_state(cfg, state_np, sgd=True, dropout_rate=0.0)
    monkeypatch.setattr(tstep, "_gp_uniforms", lambda *a: [torch.from_numpy(u) for u in uniforms])
    before = _snapshot(ts)
    batch, mocap = _torch_batch(arrays)
    metrics = tstep.make_train_step(cfg, device="cpu")(ts, batch, mocap, torch.Generator().manual_seed(0))
    assert ts.step == 1
    after = _snapshot(ts)
    assert set(_jax_grads(state_np, new_np)) == set(before)
    grads = {k: (before[k] - after[k]).numpy() for k in before}
    _assert_matches_jax(step_pair, {k: v.numpy() for k, v in vars(metrics).items()}, ts.hmr.state_dict(), grads)


@pytest.fixture(scope="module")
def two_rank_steps(step_pair, tmp_path_factory):
    """The training step on 2 gloo ranks (``tests/torch_dp_worker.py``),
    each holding 4 of the 8 rows and 12 of the 24 mocap rows (its stage
    blocks, ``parallel.mesh.row_index``), and in one process over all 8,
    from ``step_pair``'s bridged state with SGD(1). Cases: the reference
    penalty with the JAX-drawn global uniforms and dropout 0, in f32 (held
    against the JAX step) and in f64; the per-sample penalty likewise in
    f32 (held against ``step_pair_per_sample``), and in f64 with the
    uniforms and a 0.5 dropout drawn from the step's generator. One spawn
    runs the four; the one-process runs are the worker's own function.
    Returns (the ranks' results, the one-process results)."""
    state_np, _, _, arrays, uniforms = step_pair
    ts = _torch_state(Config(encoder_stage_sizes="1,1,1,1", **_cfg()), state_np, sgd=True, dropout_rate=0.0)
    weights = {"hmr": ts.hmr.state_dict(), "critic": ts.critic.state_dict(), "mean_theta": ts.mean_theta.detach()}
    gen, mocap = arrays
    base = dict(weights=weights, sgd=True, batch=gen, mocap=mocap, cfg=_cfg(encoder_stage_sizes="1,1,1,1"))
    cases = {
        "reference-f32": dict(base, dtype=torch.float32, dropout=0.0, uniforms=uniforms),
        "reference-f64": dict(base, dtype=torch.float64, dropout=0.0, uniforms=uniforms),
        "per_sample-f32": dict(
            base, cfg=dict(base["cfg"], gp_mode="per_sample"), dtype=torch.float32, dropout=0.0, uniforms=uniforms
        ),
        "per_sample-f64": dict(
            base, cfg=dict(base["cfg"], gp_mode="per_sample"), dtype=torch.float64, dropout=0.5, uniforms=None
        ),
    }
    per_rank = {k: dict(c, cfg=dict(c["cfg"], batch_size=BATCH // 2)) for k, c in cases.items()}
    ranks = dp_worker.spawn({"kind": "step", "cases": per_rank}, str(tmp_path_factory.mktemp("dp_step")))
    one = {k: dp_worker.run_step(c) for k, c in cases.items() if c["dtype"] == torch.float64}
    return ranks, one, before_names(ts)


def before_names(ts: TrainState):
    """{worker snapshot key: bridge name} of the trainable tensors, and
    their values before the step."""
    names = {f"hmr.{k}" if not k.startswith(("critic.", "mean_theta")) else k: k for k, _ in port_jax_names(ts)}
    return names, _snapshot(ts)


@pytest.mark.parametrize("case", ["reference-f32", "reference-f64", "per_sample-f32", "per_sample-f64"])
def test_two_rank_train_step(two_rank_steps, step_pair, step_pair_per_sample, case):
    """Two ranks (4 rows each) against one process (8 rows): the ranks end
    bit-equal; in f32 the step is held against the JAX f64 step of its
    ``gp_mode`` with ``test_train_step_matches_jax``'s tolerances; in f64
    against the port's one-process step at 1e-9 of each tensor's largest
    magnitude (floor: 1e-5 of the largest of all, for the conv biases
    before a BN whose exact zero gradient both hold as rounding),
    ``mr_losses`` at 1e-6: the chamfer computes in f32 on every device and
    path, so its batch sum rounds at f32."""
    ranks, one, (names, before) = two_rank_steps
    got = ranks[0][case]
    for part in ("metrics", "state"):
        for k, v in got[part].items():
            np.testing.assert_array_equal(ranks[1][case][part][k], v, err_msg=k)
    if case.endswith("f32"):
        grads = {names[k]: before[names[k]].numpy() - v for k, v in got["state"].items() if k in names}
        hmr_sd = {k[4:]: torch.from_numpy(v) for k, v in got["state"].items() if k.startswith("hmr.")}
        _assert_matches_jax(step_pair if case == "reference-f32" else step_pair_per_sample, got["metrics"],
                            hmr_sd, grads)
        return
    ref = one[case]
    for name in METRICS:
        assert_rel(got["metrics"][name], ref["metrics"][name], 1e-6 if name == "mr_losses" else 1e-9, name)
    big = max(float(np.abs(v).max()) for v in ref["state"].values())
    for k, v in ref["state"].items():
        tol = 1e-9 * max(float(np.abs(v).max()), 1e-5 * big)
        assert float(np.abs(got["state"][k] - v).max()) <= tol, (k, float(np.abs(got["state"][k] - v).max()), tol)
    assert any(k.endswith("running_var") for k in ref["state"])


def test_train_step_with_adam_moves_every_group(rng):
    """One step with the real Adam, the default cam_scale_hinge and
    dropout 0.5: finite metrics, every parameter group and the BN
    statistics move, the modules keep their mode."""
    cfg = Config(encoder_stage_sizes="1,1,1,1", **_cfg())
    assert cfg.cam_scale_hinge == 10.0
    ts = _torch_state(cfg)
    before = _snapshot(ts)
    modes = (ts.hmr.training, ts.critic.training)
    stats_before = ts.hmr.encoder.bn1.running_var.clone()
    batch, mocap = _torch_batch(_arrays(1))
    metrics = tstep.make_train_step(cfg, device="cpu")(ts, batch, mocap, torch.Generator().manual_seed(0))
    for name in METRICS:
        assert torch.isfinite(getattr(metrics, name)).all(), name
    assert metrics.kpr_losses.shape == (3,)
    after = _snapshot(ts)
    for group in ("encoder.", "regressor.", "mean_theta", "critic.kcs_dense.weight"):
        assert any((before[k] != after[k]).any() for k in before if k.startswith(group)), group
    assert not torch.equal(stats_before, ts.hmr.encoder.bn1.running_var)
    assert (ts.hmr.training, ts.critic.training) == modes
    assert ts.gen_opt.state[ts.mean_theta]["step"] == 1


@pytest.mark.parametrize("branch", ["no_mocap", "encoder_only"])
def test_train_step_branches_without_critic_update(branch):
    cfg = Config(encoder_stage_sizes="1,1,1,1", **_cfg(encoder_only=branch == "encoder_only"))
    ts = _torch_state(cfg)
    critic_before = copy.deepcopy(ts.critic.state_dict())
    batch, mocap = _torch_batch(_arrays(2))
    mocap = None if branch == "no_mocap" else mocap
    metrics = tstep.make_train_step(cfg, device="cpu")(ts, batch, mocap, torch.Generator().manual_seed(0))
    for k, v in ts.critic.state_dict().items():
        assert torch.equal(v, critic_before[k]), k
    assert float(metrics.critic_loss) == 0.0 and float(metrics.critic_penalty) == 0.0
    assert len(ts.critic_opt.state) == 0
    if branch == "no_mocap":
        assert float(metrics.bone_length_gt) == 0.0
        assert (metrics.gen_critic_losses != 0).all()
    else:  # bone_gt is a metric: computed whenever mocap is given
        assert float(metrics.bone_length_gt) > 0.0
        assert (metrics.gen_critic_losses == 0).all()
    assert torch.isfinite(metrics.generator_loss)


def test_val_step_after_train_step_uses_eval_mode():
    """make_val_step puts the modules in eval mode itself: after a training
    step, and with the modules left in train mode, the same weights and
    running statistics give the same outputs as before."""
    cfg = Config(encoder_stage_sizes="1,1,1,1", **_cfg())
    ts = _torch_state(cfg)
    batch, mocap = _torch_batch(_arrays(3))
    val = tstep.make_val_step(ts.hmr, ts.critic, cfg)
    ref = val(ts.mean_theta, batch)
    saved = copy.deepcopy((ts.hmr.state_dict(), ts.critic.state_dict(), ts.mean_theta.detach().clone()))
    tstep.make_train_step(cfg, device="cpu")(ts, batch, mocap, torch.Generator().manual_seed(0))
    ts.hmr.load_state_dict(saved[0])
    ts.critic.load_state_dict(saved[1])
    ts.hmr.train()
    ts.critic.train()
    out = val(saved[2], batch)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=1e-6, msg=k)
    assert ts.hmr.training and ts.critic.training  # the mode it had is given back
    assert torch.equal(ts.hmr.encoder.bn1.running_mean, saved[0]["encoder.bn1.running_mean"])


def test_batchnorm_train_mode_matches_flax(jax_setup, rng):
    """Train-mode features and the updated running mean / var of the
    shallow encoder against Flax ``apply(train=True,
    mutable=['batch_stats'])``, rtol 1e-5 (of each array's largest
    magnitude), from non-trivial running statistics."""
    jhmr, _, state = jax_setup
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, np.shape(a)).astype(np.float32), state.batch_stats
    )
    enc_vars = {"params": state.gen_params["encoder"], "batch_stats": stats["encoder"]}
    images = (rng.rand(4, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    ref, mut = jhmr.encoder.apply(enc_vars, jnp.asarray(images), train=True, mutable=["batch_stats"])
    hmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu")
    hmr.load_state_dict(
        port_jax.hmr_state_dict(
            jax.tree.map(np.asarray, {"params": dict(state.gen_params), "batch_stats": stats})
        )
    )
    hmr.encoder.train()
    out = hmr.encoder(torch.from_numpy(images))
    assert_rel(out, ref, 1e-5, "features")
    new = port_jax.flax_to_state_dict(
        jax.tree.map(np.asarray, state.gen_params["encoder"]), jax.tree.map(np.asarray, mut["batch_stats"])
    )
    sd = hmr.encoder.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            assert_rel(sd[k], v.numpy(), 1e-5, k)


def test_dropout_acts_on_the_last_stage_only():
    torch.manual_seed(0)
    hmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu")
    assert hmr.regressor.dropout_rate == 0.5
    images = torch.rand(2, IMG, IMG, 3) * 2 - 1
    mean = torch.from_numpy(synthetic_mean_params()).reshape(1, -1)
    hmr.train()
    drop = hmr(images, mean, generator=torch.Generator().manual_seed(3))
    again = hmr(images, mean, generator=torch.Generator().manual_seed(3))
    hmr.regressor.dropout_rate = 0.0
    plain = hmr(images, mean)
    for s in (0, 1):
        torch.testing.assert_close(drop[s].theta, plain[s].theta, rtol=0, atol=0)
    assert not torch.allclose(drop[2].theta, plain[2].theta)
    torch.testing.assert_close(drop[2].theta, again[2].theta, rtol=0, atol=0)  # same seed, same masks
    hmr.regressor.dropout_rate = 0.5
    with pytest.raises(ValueError, match="Generator"):
        hmr(images, mean)
    hmr.eval()  # eval mode never drops
    torch.testing.assert_close(hmr(images, mean)[2].theta, hmr(images, mean)[2].theta, rtol=0, atol=0)


def test_dropout_keeps_half_and_scales_by_two():
    hmr = HMR(synthetic_model(num_verts=30), encoder_stage_sizes=STAGES, device="cpu")
    x = torch.ones(256, 1024)
    y = hmr.regressor._dropout(x, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.01  # 262144 draws: sd 0.001


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_make_optimizers_match_optax(schedule):
    """Five updates from identical seeded gradients, 1e-6 of each
    parameter's largest magnitude (a few f32 ulps of the parameters: the
    two libraries round the update in another order); cosine decays over
    3 updates, so the run passes its end (rate 0)."""
    rng = np.random.RandomState(4)
    gen = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    critic = {"c": rng.randn(6).astype(np.float32)}
    gtx, ctx = jstate.make_optimizers(1e-2, 5e-2, schedule, 3)
    jg, jc = dict(gen), dict(critic)
    gs, cs = gtx.init(jg), ctx.init(jc)
    tg = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in gen.items()}
    tc = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in critic.items()}
    gopt, gsched, copt, csched = make_optimizers(list(tg.values()), list(tc.values()), 1e-2, 5e-2, schedule, 3)
    assert gopt.defaults["eps"] == 1e-7
    for _ in range(5):
        grads_g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in gen.items()}
        grads_c = {k: rng.randn(*v.shape).astype(np.float32) for k, v in critic.items()}
        up, gs = gtx.update(grads_g, gs, jg)
        jg = optax.apply_updates(jg, up)
        up, cs = ctx.update(grads_c, cs, jc)
        jc = optax.apply_updates(jc, up)
        for params, grads, opt, sched in ((tg, grads_g, gopt, gsched), (tc, grads_c, copt, csched)):
            for k, p in params.items():
                p.grad = torch.from_numpy(grads[k])
            opt.step()
            sched.step()
    for k in gen:
        assert_rel(tg[k], jg[k], 1e-6, k)
    for k in critic:
        assert_rel(tc[k], jc[k], 1e-6, k)


@pytest.mark.parametrize("mode", ["reference", "per_sample"])
def test_gradient_penalty_matches_jax(mode, rng):
    shapes = [(6, 13, 13), (6, 14, 3), (6, 10), (6, 23, 3, 3)]
    grads = [(rng.randn(*s) * 0.3).astype(np.float32) for s in shapes]
    ref = jlosses.gradient_penalty([jnp.asarray(g) for g in grads], mode=mode)
    out = tlosses.gradient_penalty([torch.from_numpy(g) for g in grads], mode=mode)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    with pytest.raises(ValueError):
        tlosses.gradient_penalty([torch.from_numpy(g) for g in grads], mode="other")


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_train_state_bridge_carries_adam(jax_setup, schedule):
    """train_state_from_jax: the bridged Adam moments are the transposed
    optax mu / nu, and one torch Adam update from a bridged 1-step JAX
    state equals one optax update on the same gradients (rtol 1e-6)."""
    _, _, state = jax_setup
    rng = np.random.RandomState(5)
    gtx, ctx = jstate.make_optimizers(1e-3, 5e-3, schedule, 4)
    rand_like = lambda tree: jax.tree.map(lambda a: jnp.asarray(rng.randn(*np.shape(a)).astype(np.float32)), tree)

    def update(state):
        gu, go = gtx.update(rand_like(state.gen_params), state.gen_opt, state.gen_params)
        cu, co = ctx.update(rand_like(state.critic_params), state.critic_opt, state.critic_params)
        return state.replace(
            step=state.step + 1,
            gen_params=optax.apply_updates(state.gen_params, gu), gen_opt=go,
            critic_params=optax.apply_updates(state.critic_params, cu), critic_opt=co,
        )

    s0 = state.replace(gen_opt=gtx.init(state.gen_params), critic_opt=ctx.init(state.critic_params))
    s1 = update(s0)
    s1_np = jax.tree.map(np.asarray, s1)
    cfg = Config(encoder_stage_sizes="1,1,1,1", lr_schedule=schedule, lr_decay_steps=4, **_cfg())
    cfg = cfg.replace(generator_lr=1e-3, critic_lr=5e-3)
    ts = _torch_state(cfg, s1_np)
    assert ts.step == 1
    bridged = port_jax.train_state_from_jax(s1_np)
    adam = next(s for s in s1_np.gen_opt if hasattr(s, "mu"))
    np.testing.assert_array_equal(
        bridged["gen_adam"]["exp_avg"]["encoder.conv1.weight"].numpy(),
        np.asarray(adam.mu["encoder"]["conv1"]["kernel"]).transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        bridged["gen_adam"]["exp_avg_sq"]["regressor.fc1.weight"].numpy(),
        np.asarray(adam.nu["regressor"]["fc1"]["kernel"]).T,
    )
    for name, p in port_jax_names(ts):
        opt = ts.critic_opt if name.startswith("critic.") else ts.gen_opt
        key = name[len("critic."):] if name.startswith("critic.") else name
        table = bridged["critic_adam"] if name.startswith("critic.") else bridged["gen_adam"]
        assert torch.equal(opt.state[p]["exp_avg"], table["exp_avg"][key]), name
        assert float(opt.state[p]["step"]) == 1.0

    rng_state = rng.get_state()
    s2 = jax.tree.map(np.asarray, update(s1))
    rng.set_state(rng_state)  # the same gradients again, for torch
    g_gen = port_jax._gen_tree_to_torch(rand_like(s1.gen_params))
    g_critic = port_jax.flax_to_state_dict(jax.tree.map(np.asarray, rand_like(s1.critic_params)))
    for name, p in port_jax_names(ts):
        p.grad = g_critic[name[len("critic."):]] if name.startswith("critic.") else g_gen[name]
    for opt, sched in ((ts.gen_opt, ts.gen_sched), (ts.critic_opt, ts.critic_sched)):
        opt.step()
        sched.step()
    ref = _jax_grads(s2, jax.tree.map(lambda a: np.zeros_like(a), s2))  # s2's values under bridge names
    for name, p in port_jax_names(ts):
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-6, atol=1e-7, err_msg=name)
