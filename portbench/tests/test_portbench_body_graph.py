"""The reader of ``smpl_graph_pct.train`` on hand-made windows: the share of
``model.smpl`` spans that hold a ``model.smpl.graph`` span, the mocap's
replays inside ``step.mocap`` left out; 0 from a program that runs the body
model eagerly, and None without spans or without body-model calls."""
import pytest

from portbench import harness as H
from portbench import spans

MS = 1_000_000  # ns


def _window(graphed, steps=2, stages=3):
    """``steps`` steps of ``stages`` body-model calls and one mocap pose
    each; the first ``graphed`` calls of the window replay the graphs, and
    so does every mocap pose."""
    recs, calls = [], 0
    for i in range(steps):
        t = i * 1000 * MS
        step = len(recs)
        recs.append(("step", -1, 7, t, t + 900 * MS))
        mocap = len(recs)
        recs.append(("step.mocap", step, 7, t + 1 * MS, t + 5 * MS))
        recs.append(("model.smpl.graph", mocap, 7, t + 2 * MS, t + 4 * MS))
        fwd = len(recs)
        recs.append(("gen.forward", step, 7, t + 10 * MS, t + 400 * MS))
        for s in range(stages):
            at = t + (100 + 50 * s) * MS
            body = len(recs)
            recs.append(("model.smpl", fwd, 7, at, at + 20 * MS))
            if calls < graphed:
                recs.append(("model.smpl.graph", body, 7, at + 1 * MS, at + 10 * MS))
            calls += 1
    return spans.reduce_events(recs, [], [], 0, steps * 1000 * MS)


class Ctx:
    def __init__(self, window):
        self.extra = {"spans": window}


def _read(ctx):
    return H.load_module("metrics", "smpl_graph_pct.train").read(ctx, None)


@pytest.mark.parametrize("graphed, share", [(6, 100.0), (3, 50.0), (0, 0.0)])
def test_the_share_of_body_model_calls_that_replay(graphed, share):
    assert _read(Ctx(_window(graphed))) == pytest.approx(share)


def test_one_stage_a_step_and_the_mocap_left_out():
    assert _read(Ctx(_window(2, stages=1))) == pytest.approx(100.0)
    assert _read(Ctx(_window(0, stages=1))) == 0.0


def test_nothing_without_spans_or_body_model_calls():
    assert _read(Ctx(None)) is None
    no_body = spans.reduce_events([("step", -1, 7, 0, 900 * MS)], [], [], 0, 2000 * MS)
    assert _read(Ctx(no_body)) is None
