"""The train-mode encoder's CUDA graph pair (``models/encoder_graph.py``).

On the CPU: each rule that keeps a call eager (the CPU itself, eval mode
and with it the int8 encoder, ``torch.no_grad``, ``remat_encoder``, a
process group, images or parameters off the gradient) is the reason
``bypass`` gives, and ``HMR.forward`` then enters no
``model.encoder.graph`` span and leaves ``encoder_graph.encode`` uncalled,
where a call that passes the rules goes through it; the capture key
separates shapes, dtypes and rebound tensors and keeps in-place loads;
and the encoder's features and BatchNorm statistics through
``HMR.forward`` equal the bare encoder's.

On a card (``cuda``): the graphed forward and every parameter gradient
against eager ResNet-50 at batch 8 and 32; capture leaves every parameter
and buffer as it found it; ``.backward()`` accumulates as eager does;
three fused training steps graphed against eager; and a restored
checkpoint or rebound weights recapture. The same for a small ViT with
stochastic depth (heads of 80 over ViT-H's 192 tokens, masks drawn up
front from the step's generator): features, gradients and the generator's
state against eager, capture leaving the parameters and the generators as
it found them, three fused HMR 2.0 steps, and rebound weights. The file
imports nothing of JAX, so it runs on the card's machine as it is.
"""
import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.models import encoder_graph
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.models.transformer_head import HeadShape
from human_pose_estimation_tpu_torch.models.vit import ViTShape
from human_pose_estimation_tpu_torch.parallel import mesh as pmesh
from human_pose_estimation_tpu_torch.train.step import HostBatch
from human_pose_estimation_tpu_torch.train.trainer import Trainer
from human_pose_estimation_tpu_torch.utils import tracing
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

IMG = 64
STAGES = (1, 1, 1, 1)


def _hmr(device="cpu", **kw):
    return HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=kw.pop("stages", STAGES),
               device=device, seed=1, **kw)


def _images(n=2, img=IMG, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, img, img, 3, generator=g) * 2 - 1).to(device)


def _mean(device="cpu"):
    return torch.zeros(1, 85, device=device)


def _gen(device="cpu"):
    """The dropout masks' generator of a train-mode forward."""
    return torch.Generator(device=device).manual_seed(0)


def _forward_spans(hmr, images, **kw):
    """``hmr`` forward under a CPU profiler: (the spans' names, the stages)."""
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        stages = hmr(images, _mean(images.device), generator=_gen(images.device), **kw)
    return [s.name for s in tracing.take()], stages


# ---------------------------------------------------------------------------
# on the CPU

# each rule's set-up of a model: (forward's keywords, the context of the call)


def _eval(hmr, images, monkeypatch):
    hmr.eval()
    return {}, contextlib.nullcontext()


def _no_grad(hmr, images, monkeypatch):
    hmr.train()
    return {}, torch.no_grad()


def _remat(hmr, images, monkeypatch):
    hmr.train()
    hmr.remat_encoder = True
    return {}, contextlib.nullcontext()


def _int8(hmr, images, monkeypatch):
    hmr.eval()
    return {"encoder_qparams": hmr.quantize_encoder()}, contextlib.nullcontext()


def _process_group(hmr, images, monkeypatch):
    # one rank of a group: the BatchNorm moments' all-reduce is the identity
    hmr.train()
    monkeypatch.setattr(pmesh, "is_distributed", lambda: True)
    monkeypatch.setattr(pmesh, "global_sum", lambda t: t)
    monkeypatch.setattr(pmesh, "world_size", lambda: 1)
    monkeypatch.setattr(pmesh, "rank", lambda: 0)
    return {}, contextlib.nullcontext()


def _frozen(hmr, images, monkeypatch):
    hmr.train()
    hmr.encoder.conv1.weight.requires_grad_(False)
    return {}, contextlib.nullcontext()


def _cpu(hmr, images, monkeypatch):
    hmr.train()
    return {}, contextlib.nullcontext()


# case: (set-up, the reason ``bypass`` gives); the int8 encoder is an
# eval-mode path that ``HMR.forward`` branches to before the rules
RULES = {
    "eval": (_eval, "eval mode"),
    "no_grad": (_no_grad, "no grad mode"),
    "remat": (_remat, "remat_encoder"),
    "int8": (_int8, "eval mode"),
    "process_group": (_process_group, "process group"),
    "frozen": (_frozen, "gradients other than the parameters'"),
    "cpu": (_cpu, "not on a CUDA device"),
}


@pytest.mark.parametrize("case", list(RULES))
def test_each_rule_keeps_the_encoder_eager(case, monkeypatch):
    hmr, images = _hmr(), _images()
    setup, reason = RULES[case]
    kw, context = setup(hmr, images, monkeypatch)

    def refuse(*a):
        raise AssertionError("the graph pair took a call that a rule keeps eager")

    monkeypatch.setattr(encoder_graph, "encode", refuse)
    captures, replays = encoder_graph.CAPTURES, encoder_graph.REPLAYS
    with context:
        assert encoder_graph.bypass(hmr, images) == reason
        names, stages = _forward_spans(hmr, images, **kw)
    assert names.count("model.encoder") == 1 and "model.encoder.graph" not in names
    assert (encoder_graph.CAPTURES, encoder_graph.REPLAYS) == (captures, replays)
    assert torch.isfinite(stages[-1].verts).all()


def test_a_call_that_passes_the_rules_takes_the_graph_pair(monkeypatch):
    """With the device rule passed, ``HMR.forward`` hands the encoder to
    ``encode`` inside ``model.encoder``."""
    hmr, images = _hmr(), _images()
    hmr.train()
    calls = []

    def encode(h, x, masks):
        calls.append((x, masks))
        with tracing.span("model.encoder.graph"):
            return h._encode(x, masks)

    monkeypatch.setattr(encoder_graph, "bypass", lambda h, x: None)
    monkeypatch.setattr(encoder_graph, "encode", encode)
    names, _ = _forward_spans(hmr, images)
    assert len(calls) == 1 and calls[0][0] is images and calls[0][1] is None  # the ResNet draws no masks
    assert names.index("model.encoder") < names.index("model.encoder.graph")
    assert names.count("model.encoder.graph") == 1


def test_the_key_separates_shapes_dtypes_and_rebound_tensors():
    hmr = _hmr()
    hmr.train()
    x8, x32 = _images(8), _images(32)
    key = encoder_graph.signature(hmr, x8)
    assert encoder_graph.signature(hmr, _images(8, seed=5)) == key  # new values, same signature
    assert encoder_graph.signature(hmr, x32) != key
    assert encoder_graph.signature(hmr, _images(8, img=IMG + 32)) != key
    assert encoder_graph.signature(hmr, x8.double()) != key
    assert encoder_graph.signature(hmr, x8.permute(0, 2, 1, 3)) != key  # other strides
    bf16 = _hmr(encoder_dtype="bfloat16")
    bf16.encoder = hmr.encoder  # the same tensors under another autocast dtype
    assert encoder_graph.signature(bf16, x8) != key
    # an in-place load keeps the storage, and so the capture
    sd = {k: v.clone() + 1 if v.is_floating_point() else v.clone() for k, v in hmr.state_dict().items()}
    hmr.load_state_dict(sd)
    assert encoder_graph.signature(hmr, x8) == key
    # a rebinding load, a move or a cast gives new storage: a new capture
    hmr.load_state_dict(sd, assign=True)
    rebound = encoder_graph.signature(hmr, x8)
    assert rebound != key
    hmr.encoder.bn1.running_mean = hmr.encoder.bn1.running_mean.clone()  # one buffer alone
    assert encoder_graph.signature(hmr, x8) not in (key, rebound)
    hmr.encoder.double()
    assert encoder_graph.signature(hmr, x8.double())[-1] != rebound[-1]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_the_encoder_output_on_the_cpu_is_unchanged(training):
    """``HMR.forward``'s features and BN statistics equal those of the bare
    encoder on a copy of the same weights."""
    hmr, images = _hmr(), _images()
    bare = copy.deepcopy(hmr.encoder)
    hmr.train(training)
    bare.train(training)
    got = []
    hook = hmr.encoder.register_forward_hook(lambda m, i, out: got.append(out))
    with torch.enable_grad():
        hmr(images, _mean(), generator=_gen())
    hook.remove()
    want = bare(images)
    assert len(got) == 1 and torch.equal(got[0], want)
    for (name, a), b in zip(hmr.encoder.named_buffers(), bare.buffers()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    """max |a - b| over max |b| (0 where both are 0)."""
    scale = b.abs().max().item()
    d = (a.double() - b.double()).abs().max().item()
    return d / scale if scale else d


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 32])
def test_graphed_forward_and_gradients_match_eager_resnet50(batch):
    """ResNet-50 in bf16 at 224 px, train mode: the graph pair's features,
    parameter gradients and BN statistics against eager on a copy of the
    same weights, over two calls (the capturing one and a replay), each
    gap within that of two eager runs."""
    dev = _card()
    graphed = _hmr(dev, stages=(3, 4, 6, 3), encoder_dtype="bfloat16")
    eager = copy.deepcopy(graphed)
    again = copy.deepcopy(graphed)
    for m in (graphed, eager, again):
        m.train()
    captures = encoder_graph.CAPTURES
    for call in range(2):
        x = _images(batch, 224, dev, seed=call)
        g_out = torch.randn(batch, 2048, generator=torch.Generator().manual_seed(call)).to(dev)
        assert encoder_graph.bypass(graphed, x) is None
        outs = {}
        for name, m in (("graphed", graphed), ("eager", eager), ("again", again)):
            params = list(m.encoder.parameters())
            f = encoder_graph.encode(m, x, None) if name == "graphed" else m._encode(x, None)
            outs[name] = (f.detach(), torch.autograd.grad(f, params, g_out), list(m.encoder.buffers()))
        (fg, gg, bg), (fe, ge, be), (fa, ga, ba) = outs["graphed"], outs["eager"], outs["again"]
        gaps = {"features": (_rel(fg, fe), _rel(fa, fe)),
                "gradient": (max(_rel(a, b) for a, b in zip(gg, ge)), max(_rel(a, b) for a, b in zip(ga, ge))),
                "buffers": (max(_rel(a.float(), b.float()) for a, b in zip(bg, be)),
                            max(_rel(a.float(), b.float()) for a, b in zip(ba, be)))}
        print(f"batch {batch} call {call}: graph-eager | eager-eager", gaps)
        for k, (graph_gap, eager_gap) in gaps.items():
            assert graph_gap <= eager_gap, (k, graph_gap, eager_gap)
    assert encoder_graph.CAPTURES == captures + 1


@pytest.mark.cuda
def test_capture_leaves_parameters_and_buffers_as_it_found_them():
    dev = _card()
    hmr = _hmr(dev, encoder_dtype="bfloat16")
    hmr.train()
    # statistics that a warm-up forward would move
    with torch.no_grad():
        for name, b in hmr.encoder.named_buffers():
            if "running" in name:
                b.uniform_(0.5, 1.5)
    before = {k: v.clone() for k, v in hmr.encoder.state_dict().items()}
    x = _images(4, IMG, dev)
    params, buffers = encoder_graph._tensors(hmr.encoder)
    pair = encoder_graph._Pair(hmr, x, params, buffers)
    for k, v in hmr.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k
    # one replay moves the statistics once, as one eager forward does
    eager = copy.deepcopy(hmr)
    encoder_graph._Replay.apply(pair, x, *params)
    eager._encode(x, None)
    for (k, a), b in zip(hmr.encoder.named_buffers(), eager.encoder.buffers()):
        assert _rel(a.float(), b.float()) < 1e-6, k
    assert int(hmr.encoder.bn1.num_batches_tracked) == int(before["bn1.num_batches_tracked"]) + 1


@pytest.mark.cuda
def test_backward_accumulates_into_grad_as_eager():
    """Two forwards and ``.backward()``s accumulate into ``.grad`` as eager
    does: the gradient buffers that the next replay refills are copied
    into ``.grad``, not taken."""
    dev = _card()
    graphed = _hmr(dev, encoder_dtype="bfloat16")
    eager = copy.deepcopy(graphed)
    for m in (graphed, eager):
        m.train()
    for seed in range(2):
        x = _images(4, IMG, dev, seed=seed)
        encoder_graph.encode(graphed, x, None).square().sum().backward()
        eager._encode(x, None).square().sum().backward()
    for (name, a), b in zip(graphed.encoder.named_parameters(), eager.encoder.parameters()):
        assert torch.equal(a.grad, b.grad), name


CANVAS, BATCH = 96, 4


def _feeds(seed=3, n=4):
    """Endless fused-path input: uint8 canvases with an elliptic figure and
    19 keypoints, and raw mocap (pose, shape), ``n`` of each in turn."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        image = rng.randint(0, 256, (BATCH, CANVAS, CANVAS, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:CANVAS, :CANVAS]
        seg = np.repeat((255 * ((((yy - 48) / 24.0) ** 2 + ((xx - 48) / 10.0) ** 2) < 1))[None, ..., None], BATCH, 0)
        hw = np.full((BATCH, 2), CANVAS, np.int32)
        center = np.full((BATCH, 2), 48, np.int32)
        label = np.stack([48 + rng.randn(BATCH, 19) * 8, 48 + rng.randn(BATCH, 19) * 16,
                          rng.rand(BATCH, 19) > 0.2], 1).astype(np.float32)
        batches.append(HostBatch(*(torch.from_numpy(a) for a in (image, seg.astype(np.uint8), hw, center, label))))
    mocap = [(torch.from_numpy((rng.randn(3 * BATCH, 72) * 0.2).astype(np.float32)),
              torch.from_numpy((rng.randn(3 * BATCH, 10) * 0.4).astype(np.float32))) for _ in range(n)]

    def cycle(items):
        while True:
            yield from items

    return cycle([(b, BATCH) for b in batches]), cycle(mocap)


def _fused_trainer(dev, checkpoint_dir, skip=0, **model):
    """A fused-path ``Trainer`` on ``dev`` whose input streams start at
    their ``skip``-th batch; ``model``: ``Config``'s model keys (the
    shallow ResNet where none are given)."""
    cfg = Config(
        img_size=IMG, batch_size=BATCH, encoder_stage_sizes="1,1,1,1", encoder_dtype="bfloat16",
        use_mesh_repro_loss=True, mr_metric_stages="all", max_silhouette_points=512, trans_max=8,
        fuse_preprocess=True, use_validation=False, log_img_step=0, model_dir=None,
        num_examples_override=1000, datasets=["lsp"], checkpoint_dir=checkpoint_dir, **model,
    )
    data, mocap = _feeds()
    for _ in range(skip):
        next(data), next(mocap)
    t = Trainer(cfg, dataset=data, mocap_dataset=mocap, smpl=synthetic_model(num_verts=120, seed=0), device=dev)
    got, step_fn = [], t.train_step

    def recording(*args):
        m = step_fn(*args)
        got.append({f.name: getattr(m, f.name).detach().clone() for f in dataclasses.fields(m)})
        return m

    t.train_step = recording
    return t, got


def _leaves(t):
    return [p.detach().clone() for p in t.state.gen_params() + list(t.state.critic.parameters())] + [
        b.detach().clone() for b in t.state.hmr.encoder.buffers()]


@pytest.mark.cuda
def test_three_fused_steps_graphed_match_eager(monkeypatch, tmp_path):
    """Three fused training steps (bf16, K2 on the card) through the graph
    pair against two eager runs: each metric and each leaf after the steps
    no further from the first eager run than the second eager run is."""
    dev = _card()
    runs = {}
    for name in ("graphed", "eager", "again"):
        with monkeypatch.context() as m:
            if name != "graphed":
                m.setattr(encoder_graph, "bypass", lambda *a, **k: "eager for the comparison")
            replays = encoder_graph.REPLAYS
            t, got = _fused_trainer(dev, str(tmp_path / name))
            t.train(max_steps=3)
            assert encoder_graph.REPLAYS - replays == (3 if name == "graphed" else 0)
            runs[name] = (got, _leaves(t))
    (mg, lg), (me, le), (ma, la) = runs["graphed"], runs["eager"], runs["again"]
    worst = {"metrics": [0.0, 0.0], "leaves": [0.0, 0.0]}
    for a, b, c in zip(mg, me, ma):
        for k in b:
            worst["metrics"][0] = max(worst["metrics"][0], _rel(a[k], b[k]))
            worst["metrics"][1] = max(worst["metrics"][1], _rel(c[k], b[k]))
    for a, b, c in zip(lg, le, la):
        worst["leaves"][0] = max(worst["leaves"][0], _rel(a.float(), b.float()))
        worst["leaves"][1] = max(worst["leaves"][1], _rel(c.float(), b.float()))
    print("graph-eager | eager-eager", worst)
    for k, (graph_gap, eager_gap) in worst.items():
        assert graph_gap <= eager_gap, (k, graph_gap, eager_gap)


@pytest.mark.cuda
def test_a_restored_checkpoint_and_rebound_weights_recapture(tmp_path):
    dev = _card()
    t, _ = _fused_trainer(dev, str(tmp_path / "ck"))
    t.train(max_steps=2)
    t.save()
    captures = encoder_graph.CAPTURES
    fresh, _ = _fused_trainer(dev, str(tmp_path / "ck"), skip=2)
    assert fresh.restore() == 2
    fresh.train(max_steps=1)
    assert encoder_graph.CAPTURES == captures + 1  # the fresh encoder's own capture
    t.train(max_steps=1)  # a replay of the first capture
    assert encoder_graph.CAPTURES == captures + 1
    for a, b in zip(_leaves(t), _leaves(fresh)):
        assert torch.equal(a, b)
    # weights rebound into the live model: the next call captures on them
    hmr = t.state.hmr
    hmr.train()
    sd = {k: v.clone() for k, v in hmr.state_dict().items()}
    x = _images(BATCH, IMG, dev)
    before = encoder_graph.signature(hmr, x)
    hmr.load_state_dict(sd, assign=True)
    assert encoder_graph.signature(hmr, x) != before
    eager = copy.deepcopy(hmr)
    f = encoder_graph.encode(hmr, x, None)
    assert encoder_graph.CAPTURES == captures + 2
    assert _rel(f, eager._encode(x, None)) == 0.0


# ---------------------------------------------------------------------------
# the ViT on the card: masks drawn up front

VIT = ViTShape(depth=4, width=160, heads=2, mlp=640)  # heads of 80, as ViT-H's; rates 0 to 0.55
VIT_IMG = 256  # ViT-H's 16 x 12 = 192 tokens
HEAD = HeadShape(depth=2, width=64, heads=4, dim_head=16, mlp=64)
VIT_CONFIG = {"backbone": "vit_h", "head": "transformer", "vit_shape": ",".join(map(str, VIT)),
              "head_shape": ",".join(map(str, HEAD))}


def _vit_hmr(device):
    return HMR(synthetic_model(num_verts=120, seed=0), backbone="vit_h", head="transformer", img_size=VIT_IMG,
               vit_shape=VIT, head_shape=HEAD, encoder_dtype="bfloat16", device=device, seed=1)


def _step_gen(dev, seed=7):
    return torch.Generator(device=dev).manual_seed(seed)


def _assert_within_eager(gaps: dict) -> None:
    """Each graph-eager gap no larger than the eager-eager gap of the same
    quantity: bit-equal where eager repeats itself bit for bit."""
    for k, (graph_gap, eager_gap) in gaps.items():
        assert graph_gap <= eager_gap, (k, graph_gap, eager_gap)


@pytest.mark.cuda
def test_graphed_forward_and_gradients_match_eager_vit():
    """The ViT in bf16, train mode, stochastic depth from the step's
    generator: the graph pair's features and parameter gradients against
    eager on copies of the same weights with generators of the same seed,
    over three calls (the capturing one and two replays), each gap within
    that of two eager runs; the generators end in the same state."""
    dev = _card()
    graphed = _vit_hmr(dev)
    eager = copy.deepcopy(graphed)
    again = copy.deepcopy(graphed)
    models = {"graphed": graphed, "eager": eager, "again": again}
    gens = {name: _step_gen(dev) for name in models}
    for m in models.values():
        m.train()
    captures = encoder_graph.CAPTURES
    for call in range(3):
        x = _images(8, VIT_IMG, dev, seed=call)
        assert encoder_graph.bypass(graphed, x) is None
        g_out = torch.randn(8, graphed.encoder.num_tokens, VIT.width, generator=torch.Generator().manual_seed(call))
        outs = {}
        for name, m in models.items():
            params = list(m.encoder.parameters())
            masks = m.encoder.draw_masks(8, gens[name])
            f = encoder_graph.encode(m, x, masks) if name == "graphed" else m._encode(x, masks)
            outs[name] = (f.detach(), torch.autograd.grad(f, params, g_out.to(dev)))
        (fg, gg), (fe, ge), (fa, ga) = outs["graphed"], outs["eager"], outs["again"]
        gaps = {"features": (_rel(fg, fe), _rel(fa, fe)),
                "gradient": (max(_rel(a, b) for a, b in zip(gg, ge)), max(_rel(a, b) for a, b in zip(ga, ge)))}
        print(f"ViT call {call}: graph-eager | eager-eager", gaps)
        _assert_within_eager(gaps)
    assert encoder_graph.CAPTURES == captures + 1
    state = gens["eager"].get_state()
    assert torch.equal(gens["graphed"].get_state(), state) and torch.equal(gens["again"].get_state(), state)


@pytest.mark.cuda
def test_vit_capture_leaves_parameters_and_generators_as_it_found_them():
    """Capture runs on a throwaway mask: the step's generator, the card's
    default generator and the parameters are as before it; the first
    replay on the step's masks gives eager's features on them."""
    dev = _card()
    hmr = _vit_hmr(dev)
    hmr.train()
    x = _images(4, VIT_IMG, dev)
    gen = _step_gen(dev)
    masks = hmr.encoder.draw_masks(4, gen)
    assert masks.shape == (6, 4)  # three blocks drop, two branches each
    step_state, default_state = gen.get_state(), torch.cuda.get_rng_state(dev)
    before = {k: v.clone() for k, v in hmr.encoder.state_dict().items()}
    params, buffers = encoder_graph._tensors(hmr.encoder)
    pair = encoder_graph._Pair(hmr, x, params, buffers, masks)
    assert torch.equal(gen.get_state(), step_state)
    assert torch.equal(torch.cuda.get_rng_state(dev), default_state)
    for k, v in hmr.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(pair.masks, torch.ones_like(masks))
    pair.masks.copy_(masks)
    f = encoder_graph._Replay.apply(pair, x, *params)
    with hmr._autocast():
        want = hmr.encoder(x, masks)
    assert _rel(f, want) == 0.0


@pytest.mark.cuda
def test_three_fused_hmr2_steps_graphed_match_eager(monkeypatch, tmp_path):
    """Three fused HMR 2.0 training steps through the graph pair against
    two eager runs: each metric and each leaf no further from the first
    eager run than the second eager run is."""
    dev = _card()
    runs = {}
    for name in ("graphed", "eager", "again"):
        with monkeypatch.context() as m:
            if name != "graphed":
                m.setattr(encoder_graph, "bypass", lambda *a, **k: "eager for the comparison")
            replays = encoder_graph.REPLAYS
            t, got = _fused_trainer(dev, str(tmp_path / name), **VIT_CONFIG)
            t.train(max_steps=3)
            assert encoder_graph.REPLAYS - replays == (3 if name == "graphed" else 0)
            runs[name] = (got, _leaves(t))
    (mg, lg), (me, le), (ma, la) = runs["graphed"], runs["eager"], runs["again"]
    gaps = {"metrics": [0.0, 0.0], "leaves": [0.0, 0.0]}
    for a, b, c in zip(mg, me, ma):
        for k in b:
            gaps["metrics"] = [max(gaps["metrics"][0], _rel(a[k], b[k])), max(gaps["metrics"][1], _rel(c[k], b[k]))]
    for a, b, c in zip(lg, le, la):
        gaps["leaves"] = [max(gaps["leaves"][0], _rel(a.float(), b.float())),
                          max(gaps["leaves"][1], _rel(c.float(), b.float()))]
    print("HMR 2.0 steps: graph-eager | eager-eager", gaps)
    _assert_within_eager(gaps)


@pytest.mark.cuda
def test_rebound_vit_weights_recapture():
    dev = _card()
    hmr = _vit_hmr(dev)
    hmr.train()
    x = _images(4, VIT_IMG, dev)
    captures = encoder_graph.CAPTURES
    encoder_graph.encode(hmr, x, hmr.encoder.draw_masks(4, _step_gen(dev)))
    encoder_graph.encode(hmr, x, hmr.encoder.draw_masks(4, _step_gen(dev)))
    assert encoder_graph.CAPTURES == captures + 1
    sd = {k: v.clone() for k, v in hmr.state_dict().items()}
    before = encoder_graph.signature(hmr, x)
    hmr.load_state_dict(sd, assign=True)
    assert encoder_graph.signature(hmr, x) != before
    eager = copy.deepcopy(hmr)
    f = encoder_graph.encode(hmr, x, hmr.encoder.draw_masks(4, _step_gen(dev, 8)))
    assert encoder_graph.CAPTURES == captures + 2
    assert _rel(f, eager._encode(x, eager.encoder.draw_masks(4, _step_gen(dev, 8)))) == 0.0
