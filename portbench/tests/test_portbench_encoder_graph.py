"""The reader of ``encoder_graph_pct.train`` on hand-made windows: the share
of ``model.encoder`` spans that hold a ``model.encoder.graph`` span, and
None without spans, without encoder calls, or from a program without the
graphed encoder."""
import importlib.util

import pytest

from portbench import harness as H
from portbench import spans

MS = 1_000_000  # ns


def _window(graphed):
    """Two steps, each with one encoder call; the first ``graphed`` of them
    replay the graph."""
    recs = []
    for i in range(2):
        t = i * 1000 * MS
        step = len(recs)
        recs.append(("step", -1, 7, t, t + 900 * MS))
        recs.append(("gen.forward", step, 7, t + 10 * MS, t + 400 * MS))
        enc = len(recs)
        recs.append(("model.encoder", step + 1, 7, t + 20 * MS, t + 100 * MS))
        if i < graphed:
            recs.append(("model.encoder.graph", enc, 7, t + 30 * MS, t + 90 * MS))
    return spans.reduce_events(recs, [], [], 0, 2000 * MS)


class Ctx:
    def __init__(self, window):
        self.extra = {"spans": window}


def _read(ctx):
    return H.load_module("metrics", "encoder_graph_pct.train").read(ctx, None)


@pytest.mark.parametrize("graphed, share", [(2, 100.0), (1, 50.0), (0, 0.0)])
def test_the_share_of_encoder_calls_that_replay(graphed, share):
    assert _read(Ctx(_window(graphed))) == pytest.approx(share)


def test_nothing_without_spans_encoder_calls_or_the_graphed_encoder(monkeypatch):
    assert _read(Ctx(None)) is None
    no_encoder = spans.reduce_events([("step", -1, 7, 0, 900 * MS)], [], [], 0, 2000 * MS)
    assert _read(Ctx(no_encoder)) is None
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("encoder_graph") else find(name, *a))
    assert _read(Ctx(_window(2))) is None
