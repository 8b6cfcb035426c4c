"""smpl_graph_pct.train: the share of the model's body-model calls that
replay its CUDA graphs (``models/body_graph.py``): 100 x the traced
window's ``model.smpl.graph`` spans whose parent is a ``model.smpl`` span,
over its ``model.smpl`` spans (``portbench/spans.py``); the mocap's replays
sit in ``step.mocap`` and are not counted. None without spans or body-model
calls; a program that runs the body model eagerly reads 0."""
from portbench.spans import reduce


def read(ctx, trace):
    w = reduce(ctx)
    if w is None or not w.calls.get("model.smpl"):
        return None
    graphed = sum(1 for i in w.inside
                  if w.spans[i][0] == "model.smpl.graph" and w.spans[i][1] >= 0
                  and w.spans[w.spans[i][1]][0] == "model.smpl")
    return 100.0 * graphed / w.calls["model.smpl"]
