"""The body model's CUDA graphs (``models/body_graph.py``).

On the CPU: each rule that keeps a call eager (the int8 encoder's path, a
pose that needs no gradient, no grad mode outside the mocap's slot, the
CPU itself) is the reason ``bypass`` gives, and ``forward`` then returns
``smpl_forward``'s outputs with nothing captured or replayed;
``HMR.forward`` hands each stage's body model to ``forward`` with the stage
as its slot, and ``mocap_batch`` with the mocap's; with stand-in graphs the
path that passes the rules captures once per slot, replays inside
``model.smpl`` and ``step.mocap``, and drops a slot's captures of a rebound
model; the key separates slots, layouts, pose forms, joint types, grad
mode and rebound tensors; a static input copies its caller's layout.

On a card (``cuda``): over three slots in one forward, the replayed
outputs against eager bit for bit in both pose forms at N = 8 and 48, and
the input gradients (bit for bit in the axis-angle form, to rtol 1e-6 in
the matrix form); the mocap's forward-only graph against eager; a stale
backward raises; a rebound model recaptures; three fused training steps of
each cell's model, graphed, against eager. The file imports nothing of
JAX, so it runs on the card's machine as it is.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from human_pose_estimation_tpu_torch.core.rotations import rot6d_to_rotmat
from human_pose_estimation_tpu_torch.core.smpl import _TENSOR_FIELDS, smpl_forward
from human_pose_estimation_tpu_torch.models import body_graph
from human_pose_estimation_tpu_torch.models.hmr import HMR
from human_pose_estimation_tpu_torch.models.transformer_head import HeadShape
from human_pose_estimation_tpu_torch.models.vit import ViTShape
from human_pose_estimation_tpu_torch.train import step as tstep
from human_pose_estimation_tpu_torch.utils import tracing
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

FORMS = ("theta", "rotations")
OUTPUTS = ("verts", "joints", "rotations", "joints_smpl")


def _inputs(n, form, device="cpu", seed=0, grad=True):
    """(the leaves, beta, the pose keywords) as the heads give them: the
    IEF's shape and axis-angle pose are slices of its theta (N, 85), HMR
    2.0's pose is matrices from 6D rotations."""
    g = torch.Generator().manual_seed(seed)
    theta = (torch.randn(n, 85, generator=g) * 0.3).to(device).requires_grad_(grad)
    if form == "theta":
        return [theta], theta[:, 75:], {"theta": theta[:, 3:75]}
    beta = theta[:, 75:].detach().clone().requires_grad_(grad)
    x6d = torch.randn(n, 24, 6, generator=g).to(device).requires_grad_(grad)
    return [beta, x6d], beta, {"theta": None, "rotations": rot6d_to_rotmat(x6d)}


def _equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in OUTPUTS)


@pytest.fixture(scope="module")
def model():
    return synthetic_model(num_verts=120, seed=0)


# ---------------------------------------------------------------------------
# on the CPU

# case: (slot, grad mode, the pose needs a gradient, int8, the reason bypass gives)
RULES = {
    "int8": (0, True, True, True, "the int8 encoder's path"),
    "pose_off_the_gradient": (1, True, False, False, "a pose that needs no gradient"),
    "no_grad": (2, False, False, False, "no grad mode"),
    "cpu": (0, True, True, False, "not on a CUDA device"),
    "mocap_on_the_cpu": (body_graph.MOCAP, False, False, False, "not on a CUDA device"),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(RULES))
def test_each_rule_keeps_the_body_model_eager(model, case, form, monkeypatch):
    slot, grad, pose_grad, int8, reason = RULES[case]

    def refuse(*a):
        raise AssertionError("the graphs took a call that a rule keeps eager")

    monkeypatch.setattr(body_graph, "_Graphs", refuse)
    captures, replays = body_graph.CAPTURES, body_graph.REPLAYS
    _, beta, pose = _inputs(4, form, grad=pose_grad)
    with torch.set_grad_enabled(grad):
        assert body_graph.bypass(slot, pose["rotations"] if form == "rotations" else pose["theta"], int8) == reason
        got = body_graph.forward(slot, model, beta, joint_type="lsp", int8=int8, **pose)
        want = smpl_forward(model, beta, joint_type="lsp", **pose)
    assert _equal(got, want)
    if form == "rotations":
        assert got.rotations is pose["rotations"]
    assert (body_graph.CAPTURES, body_graph.REPLAYS) == (captures, replays)


def test_a_pose_given_twice_or_not_at_all_is_refused(model):
    _, beta, pose = _inputs(2, "rotations")
    with pytest.raises(ValueError, match="exactly one"):
        body_graph.forward(0, model, beta, torch.zeros(2, 72), rotations=pose["rotations"])
    with pytest.raises(ValueError, match="exactly one"):
        body_graph.forward(0, model, beta, None)


def _ief():
    return HMR(synthetic_model(num_verts=120, seed=0), encoder_stage_sizes=(1, 1, 1, 1), device="cpu", seed=1)


def _vit():
    return HMR(synthetic_model(num_verts=120, seed=0), backbone="vit_h", head="transformer", img_size=64,
               vit_shape=ViTShape(2, 64, 4, 256), head_shape=HeadShape(2, 64, 4, 16, 64), device="cpu", seed=1)


def _images(n=2):
    return torch.rand(n, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1


def _recording(monkeypatch):
    """Route ``body_graph.forward`` through a recorder: (slot, the pose's
    form, int8) of each call."""
    calls, real = [], body_graph.forward

    def forward(slot, model, beta, theta, joint_type="cocoplus", rotations=None, int8=False):
        calls.append((slot, "rotations" if rotations is not None else "theta", int8))
        return real(slot, model, beta, theta, joint_type, rotations, int8)

    monkeypatch.setattr(body_graph, "forward", forward)
    return calls


@pytest.mark.parametrize("case", ["ief_train", "ief_int8", "vit_train"])
def test_hmr_and_mocap_hand_the_body_model_its_slot(case, monkeypatch):
    calls = _recording(monkeypatch)
    hmr = _vit() if case == "vit_train" else _ief()
    kw = {}
    if case == "ief_int8":
        hmr.eval()
        kw["encoder_qparams"] = hmr.quantize_encoder()
    else:
        hmr.train()
    hmr(_images(), torch.zeros(1, 85), generator=torch.Generator().manual_seed(0), **kw)
    form = "rotations" if case == "vit_train" else "theta"
    assert calls == [(s, form, case == "ief_int8") for s in range(hmr.num_stage)]
    calls.clear()
    _, beta, pose = _inputs(6, "theta", grad=False)
    mocap = tstep.mocap_batch(hmr.smpl, pose["theta"], beta)
    assert calls == [(body_graph.MOCAP, "theta", False)]
    assert torch.equal(mocap.joints, smpl_forward(hmr.smpl, beta, pose["theta"], "cocoplus").joints)


class _StandIn:
    """In place of ``_Graphs``: keeps what a capture was made from."""

    def __init__(self, model, beta, pose, joint_type, matrices):
        self.run = (model, joint_type, matrices)


def _stand_in_apply(graphs, beta, pose):
    """In place of ``_Replay.apply``: the eager outputs in the replay's order."""
    model, joint_type, matrices = graphs.run
    kw = {"theta": None, "rotations": pose} if matrices else {"theta": pose}
    out = smpl_forward(model, beta, joint_type=joint_type, **kw)
    return (out.verts, out.joints, out.joints_smpl) + (() if matrices else (out.rotations,))


def test_the_graph_path_captures_once_a_slot_and_replays_inside_its_spans(monkeypatch):
    """With the rules passed and stand-in graphs on the CPU: one capture per
    stage slot and one for the mocap's, each forward replay a
    ``model.smpl.graph`` span inside ``model.smpl`` or ``step.mocap``, the
    outputs eager's; a rebound model recaptures each slot and drops the
    slot's old captures."""
    monkeypatch.setattr(body_graph, "bypass", lambda *a, **k: None)
    monkeypatch.setattr(body_graph, "_Graphs", _StandIn)
    monkeypatch.setattr(body_graph._Replay, "apply", _stand_in_apply)
    monkeypatch.setattr(body_graph, "_graphs", {})
    hmr = _ief()
    hmr.train()
    images, mean = _images(), torch.zeros(1, 85)
    _, beta, pose = _inputs(6, "theta", grad=False)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            stages = hmr(images, mean, generator=torch.Generator().manual_seed(0))
            with tracing.span("step.mocap"), torch.no_grad():
                tstep.mocap_batch(hmr.smpl, pose["theta"], beta)
    spans = tracing.take()
    graph = [s for s in spans if s.name == "model.smpl.graph"]
    assert len(graph) == 2 * (hmr.num_stage + 1)
    assert sorted(spans[s.parent].name for s in graph) == ["model.smpl"] * 6 + ["step.mocap"] * 2
    assert sorted(str(k[0]) for k in body_graph._graphs) == ["0", "1", "2", body_graph.MOCAP]
    for s in stages:
        want = smpl_forward(hmr.smpl, s.shape, s.pose, hmr.joint_type)
        assert torch.equal(s.verts, want.verts) and torch.equal(s.rotations, want.rotations[:, 1:])
    hmr.smpl = dataclasses.replace(hmr.smpl, **{k: getattr(hmr.smpl, k).clone() for k in _TENSOR_FIELDS})
    hmr(images, mean, generator=torch.Generator().manual_seed(0))
    rebound = tuple(getattr(hmr.smpl, k).data_ptr() for k in _TENSOR_FIELDS)
    # the stages' slots hold the rebound model's captures alone; the mocap's slot was not called again
    assert {k[0]: k[-1] == rebound for k in body_graph._graphs} == {0: True, 1: True, 2: True, body_graph.MOCAP: False}
    assert len(body_graph._graphs) == 4


def test_the_key_separates_slots_layouts_forms_and_rebound_tensors(model):
    _, beta, pose = _inputs(8, "theta")
    key = body_graph.signature(0, model, beta, pose["theta"], "lsp", False)
    _, beta5, pose5 = _inputs(8, "theta", seed=5)
    assert body_graph.signature(0, model, beta5, pose5["theta"], "lsp", False) == key  # new values
    assert body_graph.signature(1, model, beta, pose["theta"], "lsp", False) != key
    assert body_graph.signature(body_graph.MOCAP, model, beta, pose["theta"], "lsp", False) != key
    _, beta48, pose48 = _inputs(48, "theta")
    assert body_graph.signature(0, model, beta48, pose48["theta"], "lsp", False) != key
    # the same values laid out contiguously: other strides and offsets
    assert body_graph.signature(0, model, beta.contiguous(), pose["theta"].contiguous(), "lsp", False) != key
    assert body_graph.signature(0, model, beta.double(), pose["theta"].double(), "lsp", False) != key
    assert body_graph.signature(0, model, beta, pose["theta"], "cocoplus", False) != key
    _, beta_r, pose_r = _inputs(8, "rotations")
    assert body_graph.signature(0, model, beta_r, pose_r["rotations"], "lsp", True) != key
    with torch.no_grad():
        assert body_graph.signature(0, model, beta, pose["theta"], "lsp", False) != key
    # a copy or a move gives new storage; the same tensors keep the key
    assert body_graph.signature(0, dataclasses.replace(model), beta, pose["theta"], "lsp", False) == key
    for k in _TENSOR_FIELDS:
        moved = dataclasses.replace(model, **{k: getattr(model, k).clone()})
        assert body_graph.signature(0, moved, beta, pose["theta"], "lsp", False) != key, k
    tree = dataclasses.replace(model, parents=(0,) + model.parents[:-1])
    assert body_graph.signature(0, tree, beta, pose["theta"], "lsp", False) != key


def test_a_static_input_copies_its_callers_layout():
    theta = torch.randn(4, 85)
    for t in (theta[:, 3:75], theta[:, 75:], torch.randn(4, 24, 3, 3)):
        s = body_graph._static(t, True)
        assert (s.shape, s.stride(), s.storage_offset()) == (t.shape, t.stride(), t.storage_offset())
        assert torch.equal(s, t) and s.is_leaf and s.requires_grad
    assert not body_graph._static(theta, False).requires_grad


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


def _loss(out, n, seed, dev):
    """A sum over every output a training step reads, with random weights."""
    g = torch.Generator().manual_seed(seed)
    w = [torch.randn(t.shape, generator=g).to(dev) for t in (out.verts, out.joints, out.rotations[:, 1:])]
    return (out.verts * w[0]).sum() + (out.joints * w[1]).sum() + (out.rotations[:, 1:] * w[2]).sum()


def _regrouped(slot, model, beta, theta, joint_type="cocoplus", rotations=None, int8=False):
    """Eager ``smpl_forward``, but in the matrix form the body model reads a
    copy of the caller's matrices: its gradient of them is summed apart and
    then added to the caller's own, in the graphs' order of that one sum."""
    if rotations is None:
        return smpl_forward(model, beta, theta, joint_type)
    return dataclasses.replace(smpl_forward(model, beta, None, joint_type, rotations.clone()), rotations=rotations)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 48])
@pytest.mark.parametrize("form", FORMS)
def test_replayed_outputs_and_gradients_match_eager(form, n):
    """Three slots forward in turn, then each slot's backward, over the
    capturing call and a replay: the outputs against eager bit for bit; the
    input gradients bit for bit in the axis-angle form; in the matrix form
    bit for bit against eager with the one sum regrouped, and to 1e-6 of
    their largest against plain eager."""
    dev = _card()
    model = synthetic_model(num_verts=6890, seed=0).to(dev)
    captures = body_graph.CAPTURES
    for call in range(2):
        runs = {}
        for name, fn in (("graphed", body_graph.forward), ("eager", _regrouped),
                         ("plain", lambda slot, *a, **k: smpl_forward(*a, **k))):
            runs[name] = []
            for slot in range(3):
                leaves, beta, pose = _inputs(n, form, dev, seed=10 * call + slot)
                runs[name].append((leaves, fn(slot, model, beta, joint_type="lsp", **pose)))
        for slot in (2, 0, 1):
            grads = {}
            for name, (leaves, out) in ((k, v[slot]) for k, v in runs.items()):
                assert _equal(out, runs["plain"][slot][1]), (name, form, n, call, slot)
                grads[name] = torch.autograd.grad(_loss(out, n, slot, dev), leaves)
            regrouped = [_rel(a, b) for a, b in zip(grads["graphed"], grads["eager"])]
            plain = [_rel(a, b) for a, b in zip(grads["graphed"], grads["plain"])]
            print(f"{form} N={n} call {call} slot {slot}: gradient gaps to the regrouped {regrouped}, "
                  f"to plain eager {plain}")
            assert regrouped == [0.0] * len(regrouped)
            assert max(plain) <= (0.0 if form == "theta" else 1e-6), plain
    assert body_graph.CAPTURES == captures + 3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [24, 48])
def test_the_mocap_forward_only_graph_matches_eager(m):
    dev = _card()
    model = synthetic_model(num_verts=6890, seed=0).to(dev)
    captures, replays = body_graph.CAPTURES, body_graph.REPLAYS
    got = []
    for call in range(2):
        _, beta, pose = _inputs(m, "theta", dev, seed=call, grad=False)
        beta, theta = beta.contiguous(), pose["theta"].contiguous()  # as the mocap stream hands them over
        mocap = tstep.mocap_batch(model, theta, beta)
        with torch.no_grad():
            want = smpl_forward(model, beta, theta, "cocoplus")
        assert torch.equal(mocap.joints, want.joints) and torch.equal(mocap.rotations, want.rotations[:, 1:])
        got.append((mocap, want))
    first, want = got[0]
    assert torch.equal(first.joints, want.joints)  # a later replay leaves an earlier result alone
    assert (body_graph.CAPTURES, body_graph.REPLAYS) == (captures + 1, replays + 2)


@pytest.mark.cuda
def test_a_stale_backward_raises():
    dev = _card()
    model = synthetic_model(num_verts=120, seed=0).to(dev)
    leaves0, beta0, pose0 = _inputs(4, "theta", dev, seed=0)
    leaves1, beta1, pose1 = _inputs(4, "theta", dev, seed=1)
    old = body_graph.forward(0, model, beta0, joint_type="lsp", **pose0)
    new = body_graph.forward(0, model, beta1, joint_type="lsp", **pose1)
    with pytest.raises(RuntimeError, match="activations of its own forward"):
        torch.autograd.grad(old.verts.sum(), leaves0)
    loss = new.verts.sum()
    torch.autograd.grad(loss, leaves1, retain_graph=True)
    with pytest.raises(RuntimeError, match="activations of its own forward"):
        torch.autograd.grad(loss, leaves1)


@pytest.mark.cuda
def test_a_rebound_model_recaptures():
    dev = _card()
    model = synthetic_model(num_verts=120, seed=0).to(dev)
    _, beta, pose = _inputs(4, "theta", dev)
    captures = body_graph.CAPTURES
    body_graph.forward(0, model, beta, joint_type="lsp", **pose)
    body_graph.forward(0, model.to(dev), beta, joint_type="lsp", **pose)  # the same tensors
    assert body_graph.CAPTURES == captures + 1
    rebound = model.to("cpu").to(dev)
    got = body_graph.forward(0, rebound, beta, joint_type="lsp", **pose)
    assert body_graph.CAPTURES == captures + 2
    assert _equal(got, smpl_forward(rebound, beta, joint_type="lsp", **pose))
    ptrs = tuple(getattr(rebound, k).data_ptr() for k in _TENSOR_FIELDS)
    assert [k[-1] for k in body_graph._graphs if k[0] == 0] == [ptrs]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet-ief", "vit_h-transformer"])
def test_three_fused_steps_graphed_match_eager(cell, monkeypatch, tmp_path):
    """Three fused training steps of each cell's model at a small size,
    the body model graphed, against two eager runs (the encoder graphed in
    all three) with the matrix form's one sum regrouped (``_regrouped``):
    each metric and each leaf no further from the first eager run than the
    second eager run is. The gap to plain eager is printed: none in the
    axis-angle form, where the regrouping does nothing."""
    dev = _card()
    from test_torch_encoder_graph import VIT_CONFIG, _fused_trainer, _leaves

    model = VIT_CONFIG if cell == "vit_h-transformer" else {}
    runs = {}
    for name in ("graphed", "eager", "again", "plain"):
        with monkeypatch.context() as m:
            if name in ("eager", "again"):
                m.setattr(body_graph, "forward", _regrouped)
            elif name == "plain":
                m.setattr(body_graph, "bypass", lambda *a, **k: "eager for the comparison")
            replays = body_graph.REPLAYS
            t, got = _fused_trainer(dev, str(tmp_path / name), **model)
            t.train(max_steps=3)
            per_step = t.state.hmr.num_stage + 1  # the stages and the mocap
            assert body_graph.REPLAYS - replays == (3 * per_step if name == "graphed" else 0)
            runs[name] = (got, _leaves(t))

    def gaps(x, y):
        (mx, lx), (my, ly) = runs[x], runs[y]
        return {"metrics": max(_rel(a[k], b[k]) for a, b in zip(mx, my) for k in b),
                "leaves": max(_rel(a.float(), b.float()) for a, b in zip(lx, ly))}

    graph, eager = gaps("graphed", "eager"), gaps("again", "eager")
    print(f"{cell} steps: graph-eager {graph} | eager-eager {eager} | graph-plain eager {gaps('graphed', 'plain')}")
    for k in graph:
        assert graph[k] <= eager[k], (k, graph[k], eager[k])
