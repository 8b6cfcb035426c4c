"""The port's named spans (``utils/tracing.py``) over ``Trainer.train`` on
the fused path, on the CPU at a small size (a (1, 1, 1, 1) encoder, 96 px
canvases cropped to 64, the 120-vertex asset, batch 4, 12 mocap a step).

With no profiler a span is the shared no-op context and nothing is kept.
Under ``torch.profiler`` two steps record the documented names, nested as
documented, with their counts a step; each span holds the profiler's own
event of that name, the two a median 1 ms apart or less (one clock); and
the steps' metrics and parameters are bit-equal with and without a
profiler recording."""
import dataclasses
import re
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from human_pose_estimation_tpu_torch.config import Config
from human_pose_estimation_tpu_torch.train.step import HostBatch
from human_pose_estimation_tpu_torch.train.trainer import Trainer
from human_pose_estimation_tpu_torch.utils import tracing
from human_pose_estimation_tpu_torch.utils.assets import synthetic_model

CANVAS, BATCH, STEPS = 96, 4, 2

# each name's parent on the fused path, and its count in one step
TREE = {
    "loop.iter": (None, 1), "loop.next": ("loop.iter", 1), "step": ("loop.iter", 1),
    "step.prep": ("step", 1), "step.mocap": ("step", 1),
    "gen.forward": ("step", 1), "model.encoder": ("gen.forward", 1), "model.ief": ("gen.forward", 3),
    "model.smpl": ("gen.forward", 3),
    "gen.losses": ("step", 1), "chamfer.k2": ("gen.losses", 3), "critic.score": ("gen.losses", 3),
    "gen.backward": ("step", 1), "gen.adam": ("step", 1),
    "critic.forward": ("step", 1), "critic.penalty": ("critic.forward", 1),
    "critic.backward": ("step", 1), "critic.adam": ("step", 1), "step.metrics": ("step", 1),
    "loop.fetch": ("loop.iter", 1), "loop.log": ("loop.iter", 1),
}
# documented spans of another model's path: HMR 2.0's head in place of
# model.ief (tests/test_torch_hmr2.py counts them), and Multi-HMR's head and
# detection loss on person slots (tests/test_torch_multihmr.py counts them)
OTHER_PATHS = {"model.head", "model.camera", "model.queries", "gen.detect"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _feeds():
    """Endless fused-path input: uint8 canvases with an elliptic figure
    in the seg and 19 keypoints, and raw mocap (pose, shape)."""
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(STEPS):
        image = rng.randint(0, 256, (BATCH, CANVAS, CANVAS, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:CANVAS, :CANVAS]
        seg = np.repeat((255 * ((((yy - 48) / 24.0) ** 2 + ((xx - 48) / 10.0) ** 2) < 1))[None, ..., None], BATCH, 0)
        hw = np.full((BATCH, 2), CANVAS, np.int32)
        center = np.full((BATCH, 2), 48, np.int32)
        label = np.stack([48 + rng.randn(BATCH, 19) * 8, 48 + rng.randn(BATCH, 19) * 16,
                          rng.rand(BATCH, 19) > 0.2], 1).astype(np.float32)
        batches.append(HostBatch(*(torch.from_numpy(a) for a in (image, seg.astype(np.uint8), hw, center, label))))
    mocap = [(torch.from_numpy((rng.randn(3 * BATCH, 72) * 0.2).astype(np.float32)),
              torch.from_numpy((rng.randn(3 * BATCH, 10) * 0.4).astype(np.float32))) for _ in range(STEPS)]

    def cycle(items):
        while True:
            yield from items

    return cycle([(b, BATCH) for b in batches]), cycle(mocap)


def _trainer():
    cfg = Config(
        img_size=64, batch_size=BATCH, encoder_stage_sizes="1,1,1,1", encoder_dtype="float32",
        use_mesh_repro_loss=True, mr_metric_stages="all", max_silhouette_points=512, trans_max=8,
        fuse_preprocess=True, use_validation=False, log_img_step=0, model_dir=None,
        num_examples_override=1000, datasets=["lsp"],
    )
    data, mocap = _feeds()
    t = Trainer(cfg, dataset=data, mocap_dataset=mocap, smpl=synthetic_model(num_verts=120, seed=0), device="cpu")
    got, step_fn = [], t.train_step

    def recording(*args):
        m = step_fn(*args)
        got.append({f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)})
        return m

    t.train_step = recording
    return t, got


@pytest.fixture(scope="module")
def runs():
    """Two steps of one Trainer without a profiler and two of a second,
    equal one under a CPU profiler: (metrics, parameters, spans, the
    profiler's span events) of each."""
    tracing.take()  # spans that another test's profiler left
    plain, plain_got = _trainer()
    plain.train(max_steps=STEPS)
    untraced = tracing.take()

    traced, traced_got = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.train(max_steps=STEPS)
    spans = tracing.take()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() in TREE]
    params = lambda t: [p.detach().clone() for p in t.state.gen_params() + list(t.state.critic.parameters())]  # noqa: E731
    return {"untraced": untraced, "spans": spans, "events": events,
            "metrics": (plain_got, traced_got), "params": (params(plain), params(traced))}


def test_without_a_profiler_a_span_is_the_shared_no_op(runs):
    assert tracing.span("step") is tracing.span("loop.iter") is tracing._NULL
    assert runs["untraced"] == []


def test_the_documented_spans_nest_and_count_per_step(runs):
    spans = runs["spans"]
    names = [s.name for s in spans]
    assert set(names) == set(TREE)
    # the module's table of names, which is the operators' reference
    assert set(re.findall(r"^ {4,}([a-z]+\.[a-z0-9]+|step) ", tracing.__doc__, re.M)) == set(TREE) | OTHER_PATHS
    for name, (parent, per_step) in TREE.items():
        assert names.count(name) == per_step * STEPS, name
    for s in spans:
        parent = TREE[s.name][0]
        assert (spans[s.parent].name if s.parent >= 0 else None) == parent, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)
    assert all(s.thread == spans[0].thread for s in spans)


def test_spans_share_the_profilers_clock(runs):
    """A span stamps its start before its profiler range opens and its end
    after the range closes, so on one clock each profiler event lies inside
    its span. A thread that gives up the interpreter lock inside the range's
    entry may wait up to the switch interval (5 ms) to run again, so the
    1 ms bound holds for the median gap, not for each."""
    spans, events = runs["spans"], runs["events"]
    assert len(events) == len(spans)
    gaps = []
    for name in TREE:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted((s, e) for n, s, e in events if n == name)
        assert len(mine) == len(theirs), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert s0 - 50_000 <= s1 and e1 <= e0 + 50_000, (name, s1 - s0, e0 - e1)
            gaps += [s1 - s0, e0 - e1]
    assert statistics.median(gaps) < 1_000_000, statistics.median(gaps)
    # the clock is the wall clock's epoch, which time.time_ns reads
    assert abs(spans[-1].end_ns - time.time_ns()) < 600e9


def test_a_recording_profiler_leaves_the_steps_bit_equal(runs):
    plain, traced = runs["metrics"]
    assert len(plain) == len(traced) == STEPS
    for a, b in zip(plain, traced):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(*runs["params"]):
        assert torch.equal(a, b)
