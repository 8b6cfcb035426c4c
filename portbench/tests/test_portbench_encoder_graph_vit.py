"""The reader of ``encoder_graph_pct.vit.train`` on hand-made windows: the
share of the ViT's ``model.encoder`` spans that hold a
``model.encoder.graph`` span, 0 from a program that runs the ViT eagerly,
and None without spans, without encoder calls, or in a ResNet cell."""
import pytest

from portbench import harness as H
from portbench import spans

MS = 1_000_000  # ns


def _window(graphed, steps=3):
    """``steps`` steps, each with one encoder call; the first ``graphed``
    of them replay the graph."""
    recs = []
    for i in range(steps):
        t = i * 1000 * MS
        step = len(recs)
        recs.append(("step", -1, 7, t, t + 900 * MS))
        recs.append(("gen.forward", step, 7, t + 10 * MS, t + 400 * MS))
        enc = len(recs)
        recs.append(("model.encoder", step + 1, 7, t + 20 * MS, t + 100 * MS))
        if i < graphed:
            recs.append(("model.encoder.graph", enc, 7, t + 30 * MS, t + 90 * MS))
        recs.append(("model.head", step + 1, 7, t + 110 * MS, t + 120 * MS))
    return spans.reduce_events(recs, [], [], 0, steps * 1000 * MS)


class Ctx:
    def __init__(self, window, backbone="vit_h"):
        self.extra = {"spans": window}
        self.config = {"backbone": backbone}


def _read(ctx):
    return H.load_module("metrics", "encoder_graph_pct.vit.train").read(ctx, None)


@pytest.mark.parametrize("graphed, share", [(3, 100.0), (1, 100.0 / 3), (0, 0.0)])
def test_the_share_of_vit_calls_that_replay(graphed, share):
    assert _read(Ctx(_window(graphed))) == pytest.approx(share)


def test_nothing_without_spans_encoder_calls_or_the_vit():
    assert _read(Ctx(None)) is None
    no_encoder = spans.reduce_events([("step", -1, 7, 0, 900 * MS)], [], [], 0, 2000 * MS)
    assert _read(Ctx(no_encoder)) is None
    assert _read(Ctx(_window(3), backbone="resnet")) is None
    assert _read(Ctx(_window(3), backbone=None)) is None
