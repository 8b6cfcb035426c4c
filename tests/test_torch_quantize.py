"""The port's int8 encoder (``models/quantize.py``, ``HMR.quantize_encoder``,
the int8 ``Predictor``) against the JAX package's on the CPU: the shallow
encoder (1, 1, 1, 1) at 64 px (and a (1, 1) encoder for the functions run
op by op), the 120-vertex body, both sides from one Flax tree of seeded
numpy weights whose BN parameters and statistics are perturbed as
``tests/test_quantize.py::_realistic_variables`` does (activations survive
the ReLUs), bridged into the port with ``models/port_jax.py``.

The functions of ``models/quantize.py`` are held against the JAX ones run
op by op, which round where the source says. Compiled, XLA:CPU rewrites
them: with ``xla_allow_excess_precision`` on (its default) it keeps the
bf16-rounded int8 accumulator in f32, so that the default
``conv_out_dtype=bfloat16`` computes what the int32 mode does (1.6%
relative L2 from the program as written, on a (1, 1, 1, 1) encoder's
features); with it off the static modes agree and the dynamic one is
still 0.5% off there. The whole
HMR and Predictor are held against the JAX ones compiled with that flag
off. Measured maxima (torch 2.13 and jax 0.9 on the CPU) are in each
docstring.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from human_pose_estimation_tpu.config import Config as JConfig
from human_pose_estimation_tpu.infer.predictor import Predictor as JPredictor
from human_pose_estimation_tpu.models import quantize as jq
from human_pose_estimation_tpu.models.hmr import HMR as JHMR
from human_pose_estimation_tpu.utils.assets import synthetic_mean_params
from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.infer.predictor import Predictor
from human_pose_estimation_tpu_torch.models import port_jax
from human_pose_estimation_tpu_torch.models import quantize as tq
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

IMG = 64
STAGES = (1, 1, 1, 1)
# compiled JAX programs that round where the source says (bf16 accumulators)
jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _seeded_variables(init, seed):
    """A Flax module's variables from seeded numpy, in the tree that
    ``init()`` gives (its shapes from ``jax.eval_shape``, no compile):
    lecun-normal kernels (the regressor's output layer scaled by 0.01, as
    the reference's small last init), then the perturbation of
    ``_realistic_variables`` (tests/test_quantize.py): var * exp(0.1 N),
    mean, bias and scale + 0.05 N, so that folding is non-trivial and
    activations survive the ReLUs."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init)

    def fill(path, leaf):
        names = [str(getattr(k, "key", k)) for k in path]
        name = names[-1]
        if name == "kernel":
            a = rng.randn(*leaf.shape) * np.sqrt(1.0 / np.prod(leaf.shape[:-1]))
            a = a * (0.01 if "out" in names else 1.0)
        elif name in ("scale", "var"):
            a = np.ones(leaf.shape)
        else:
            a = np.zeros(leaf.shape)
        if name == "var":
            a = a * np.exp(rng.randn(*leaf.shape) * 0.1)
        elif name in ("mean", "bias", "scale"):
            a = a + rng.randn(*leaf.shape) * 0.05
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def state(tiny_model):
    """(JAX HMR, its variables, the port's HMR, mean theta as numpy and as
    a tensor, images in [-1, 1], the JAX int8 tree of the HMR's encoder)."""
    jhmr = JHMR(tiny_model, num_stage=3, joint_type="lsp", encoder_stage_sizes=STAGES)
    v = _seeded_variables(lambda: jhmr.init(jax.random.PRNGKey(0), img_size=IMG), seed=0)
    variables = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    thmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu")
    thmr.load_state_dict(port_jax.hmr_state_dict(variables))
    mean = synthetic_mean_params()[None, :].astype(np.float32)
    images = np.random.RandomState(1).uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    jweights = jax.tree.map(
        np.asarray,
        jax.jit(lambda v: jq.quantize_resnet(v["params"]["encoder"], v["batch_stats"]["encoder"], STAGES))(variables),
    )
    return jhmr, variables, thmr, mean, port_jax.mean_theta(mean), images, jweights


@pytest.fixture(scope="module")
def encoder():
    """A two-stage encoder (the JAX encoder tests' (1, 1)) for the
    functions run op by op on the JAX side: (its int8 tree from JAX, the
    port's encoder, images)."""
    from human_pose_estimation_tpu.models.resnet import ResNet as JResNet
    from human_pose_estimation_tpu_torch.models.resnet import ResNet

    stages = (1, 1)
    jenc = JResNet(stage_sizes=stages)
    v = _seeded_variables(lambda: jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False), 1)
    enc = ResNet(stages)
    enc.load_state_dict(port_jax.flax_to_state_dict(v["params"], v["batch_stats"]))
    enc.eval()
    jweights = jax.tree.map(np.asarray, jax.jit(lambda v: jq.quantize_resnet(v["params"], v["batch_stats"], stages))(v))
    images = np.random.RandomState(2).uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    return jweights, enc, images


def _to_port(jtree):
    """A JAX int8 tree in the port's layout: w (kh, kw, ic, oc) -> (oc, kh, kw, ic)."""
    if "w" in jtree:
        return {
            "w": torch.from_numpy(np.ascontiguousarray(np.transpose(jtree["w"], (3, 0, 1, 2)))),
            "s": torch.from_numpy(np.array(jtree["s"])),
            "b": torch.from_numpy(np.array(jtree["b"])),
        }
    return {k: _to_port(v) for k, v in jtree.items()}


def _convs(jtree, ttree, path=""):
    if "w" in ttree:
        yield path, jtree, ttree
        return
    for k in ttree:
        yield from _convs(jtree[k], ttree[k], f"{path}/{k}")


def test_fold_conv_bn_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 16, 32).astype(np.float32)  # HWIO
    b = rng.randn(32).astype(np.float32)
    bn = {
        "scale": rng.rand(32).astype(np.float32) + 0.5, "bias": rng.randn(32).astype(np.float32),
        "mean": rng.randn(32).astype(np.float32), "var": rng.rand(32).astype(np.float32) + 0.3,
    }
    ref = jq.fold_conv_bn(w, b, bn)
    got = tq.fold_conv_bn(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), torch.from_numpy(b),
                          {k: torch.from_numpy(v) for k, v in bn.items()})
    np.testing.assert_allclose(got["kernel"].numpy(), np.transpose(ref["kernel"], (3, 2, 0, 1)), rtol=1e-6)
    np.testing.assert_allclose(got["bias"].numpy(), ref["bias"], rtol=1e-6, atol=1e-6)


def test_quantize_resnet_matches_jax(state):
    """Against the compiled JAX fold, whose rewrites change the last bit of
    about a quarter of the folded elements, w_q is element-equal but for
    rounding ties: at most 1 in 1e4 elements one level off (measured: 1, 1,
    1 and 3 elements in four of the 17 tensors, 3 of 2,097,152 at most;
    none against the fold run op by op). s and b rtol 1e-6 (measured: s
    2.2e-7)."""
    _, _, thmr, _, _, _, jweights = state
    tweights = thmr.quantize_encoder()["weights"]
    convs = list(_convs(jweights, tweights))
    assert len(convs) == 17  # stem + 4 blocks of 3 convolutions and a projection
    for path, j, t in convs:
        jw = np.transpose(j["w"], (3, 0, 1, 2)).astype(np.int32)
        tw = t["w"].numpy().astype(np.int32)
        assert tw.shape == jw.shape and t["w"].dtype == torch.int8, path
        off = np.abs(tw - jw)
        assert off.max() <= 1 and (off > 0).sum() <= max(1, tw.size // 10_000), (path, int((off > 0).sum()), tw.size)
        np.testing.assert_allclose(t["s"].numpy(), j["s"], rtol=1e-6, err_msg=path)
        np.testing.assert_allclose(t["b"].numpy(), j["b"], rtol=1e-6, atol=1e-6, err_msg=path)


def test_calibrate_resnet_matches_jax(encoder):
    """The same int8 tree and images: every site's scale within rtol 1e-5
    (measured: equal)."""
    jweights, _, images = encoder
    ref = jq.calibrate_resnet(jweights, images, (1, 1))
    got = tq.calibrate_resnet(_to_port(jweights), torch.from_numpy(images), (1, 1))
    assert set(got) == set(ref) and len(got) == 8
    for site in ref:
        np.testing.assert_allclose(float(got[site]), float(ref[site]), rtol=1e-5, err_msg=site)


@pytest.mark.parametrize("mode", ["bfloat16", "int32", "dynamic"])
def test_resnet_apply_int8_matches_jax(encoder, mode):
    """The same int8 tree and activation scales: the features within
    relative L2 1e-3 (measured: 1.3e-7 in every mode); the int8 features
    track the f32 encoder within 0.03 (test_int8_encoder_tracks_f32's
    bound; measured 0.0091-0.0094)."""
    jweights, enc, images = encoder
    act = None
    if mode != "dynamic":
        act = jax.tree.map(np.asarray, jq.calibrate_resnet(jweights, images, (1, 1)))
    jdtype, tdtype = (jnp.int32, torch.int32) if mode == "int32" else (jnp.bfloat16, torch.bfloat16)
    ref = jq.resnet_apply_int8(jweights, images, (1, 1), act_scales=act, conv_out_dtype=jdtype)
    tact = None if act is None else {k: torch.tensor(v) for k, v in act.items()}
    got = tq.resnet_apply_int8(_to_port(jweights), torch.from_numpy(images), (1, 1), act_scales=tact,
                               conv_out_dtype=tdtype)
    assert got.shape == (3, 512) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), ref) <= 1e-3, rel_l2(got.numpy(), ref)
    with torch.no_grad():
        f32 = enc(torch.from_numpy(images)).numpy()
    assert np.linalg.norm(f32) > 0.1
    assert rel_l2(got.numpy(), f32) < 0.03, rel_l2(got.numpy(), f32)


def test_hmr_int8_matches_jax(state):
    """HMR.quantize_encoder calibrated on the images, then the int8
    forward: verts and joints within atol 5e-3 of the JAX int8 HMR
    (measured: 3.0e-4 and 1.4e-4; 3.5e-4 and 1.8e-4 against the JAX HMR
    compiled with XLA's defaults; the int8 HMR is 3.5e-4 from the f32 one)."""
    jhmr, variables, thmr, mean, mean_t, images, _ = state
    jqp = jit(lambda v, c: jhmr.quantize_encoder(v, calibration_images=c))(variables, images)
    ref, _ = jit(lambda v, x, m, q: jhmr(v, x, m, train=False, smpl_stages="last", encoder_qparams=q))(
        variables, images, mean, jqp
    )
    with torch.no_grad():
        qp = thmr.quantize_encoder(torch.from_numpy(images))
        got = thmr(torch.from_numpy(images), mean_t, smpl_stages="last", encoder_qparams=qp)
    for key in ("verts", "joints3d"):
        err = np.abs(getattr(got[-1], key).numpy() - np.asarray(getattr(ref[-1], key))).max()
        assert err <= 5e-3, (key, err)


def test_hmr_int8_train_mode_rejected(state):
    _, _, thmr, _, mean_t, images, _ = state
    qp = thmr.quantize_encoder()
    assert qp["act"] is None
    thmr.train()
    try:
        with pytest.raises(ValueError, match="inference-only"):
            thmr(torch.from_numpy(images[:1]), mean_t, encoder_qparams=qp, generator=torch.Generator())
    finally:
        thmr.eval()


def _port_predictor(state, batch, **kw):
    _, variables, thmr, _, mean_t, _, _ = state
    cfg = Config(img_size=IMG, batch_size=batch, encoder_dtype="float32", encoder_stage_sizes="1,1,1,1")
    return Predictor(cfg, smpl=synthetic_model(num_verts=120, seed=0), variables=thmr.state_dict(),
                     mean_theta=mean_t, device="cpu", encoder_int8=True, **kw)


def test_predictor_int8_matches_jax(state, tiny_model):
    """A Predictor calibrated on uint8 images (normalized first) against
    the JAX int8 Predictor on the same calibration: every output within
    atol 5e-3 on a padded batch (measured: 8.5e-5 at most, theta; 2.2e-4
    against the JAX Predictor compiled with XLA's defaults)."""
    jhmr, variables, _, mean, _, _, _ = state
    rng = np.random.RandomState(2)
    calib = rng.randint(0, 256, size=(3, IMG, IMG, 3)).astype(np.uint8)
    requests = rng.randint(0, 256, size=(3, IMG, IMG, 3)).astype(np.uint8)
    jp = JPredictor.__new__(JPredictor)
    jp.config = JConfig(img_size=IMG, batch_size=4, num_stage=3)
    jp.batch_size, jp.outputs, jp.mesh, jp.smpl, jp.hmr = 4, None, None, tiny_model, jhmr
    jp.variables, jp.mean_theta = variables, jnp.asarray(mean)
    jp.encoder_qparams = jit(lambda v, c: jhmr.quantize_encoder(v, calibration_images=c))(
        variables, calib.astype(np.float32) / 127.5 - 1.0
    )
    jp._predict = jit(jp._predict_impl)
    ref = jp.predict(requests)
    tp = _port_predictor(state, 4, calibration_images=calib)
    assert tp.encoder_qparams["act"] is not None
    got = tp.predict(requests)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 5e-3, (k, err)


def test_predictor_lazy_calibration(state):
    """Without calibration images: a warm-up call (calibrate=False) and an
    empty request keep no scales; the first real request calibrates on its
    unpadded rows only (equal to calibrate_resnet on them alone), and the
    next call serves the same frozen scales."""
    p = _port_predictor(state, 4)
    assert p.encoder_qparams["act"] is None
    warm = np.zeros((4, IMG, IMG, 3), np.uint8)
    p.predict(warm, calibrate=False)
    assert p.encoder_qparams["act"] is None
    p.predict(warm[:0])
    assert p.encoder_qparams["act"] is None
    one = np.random.RandomState(3).randint(0, 256, size=(1, IMG, IMG, 3)).astype(np.uint8)
    first = p.predict(one)  # one row, padded to 4
    act = p.encoder_qparams["act"]
    assert act is not None
    want = tq.calibrate_resnet(p.encoder_qparams["weights"], torch.from_numpy(one).float() / 127.5 - 1.0, STAGES)
    for site in want:
        assert torch.equal(act[site], want[site]), site
    again = p.predict(one)
    assert p.encoder_qparams["act"] is act
    for k in first:
        np.testing.assert_array_equal(first[k], again[k])


def test_export_refuses_uncalibrated_int8(state, tmp_path):
    from human_pose_estimation_tpu_torch.infer.export import export_predictor

    p = _port_predictor(state, 2)
    with pytest.raises(ValueError, match="UNCALIBRATED"):
        export_predictor(p, str(tmp_path / "never_written.pt2"), platforms=("cpu",))
    assert not os.listdir(tmp_path)


@pytest.mark.cuda
def test_int8_encoder_on_card_matches_cpu():
    """The same int8 code on the card and on the CPU (im2col, _int_mm, the
    int8 pool, the epilogues): calibration and features of a shallow
    encoder within relative 1e-3 (the integer accumulations are exact).
    Needs no fixture of the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    thmr = HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=STAGES, device="cpu", seed=5)
    images = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32))
    qp = thmr.quantize_encoder(images)
    card = thmr.to("cuda")
    card.smpl, card.device = card.smpl.to("cuda"), torch.device("cuda")
    qp_card = card.quantize_encoder(images.cuda())
    for site, s in qp["act"].items():
        np.testing.assert_allclose(float(qp_card["act"][site]), float(s), rtol=1e-3, err_msg=site)
    got = tq.resnet_apply_int8(qp_card["weights"], images.cuda(), STAGES, act_scales=qp_card["act"]).cpu()
    want = tq.resnet_apply_int8(qp["weights"], images, STAGES, act_scales=qp["act"])
    assert rel_l2(got.numpy(), want.numpy()) <= 1e-3
