"""encoder_graph_pct.train: the share of the train-mode encoder's calls that
replay its CUDA graph pair: 100 x the traced window's ``model.encoder.graph``
spans over its ``model.encoder`` spans (``portbench/spans.py``). None
without spans or encoder calls, and where the program has no graphed
encoder (``models/encoder_graph.py``), so has no such span."""
import importlib.util

from portbench.spans import reduce


def read(ctx, trace):
    w = reduce(ctx)
    if w is None or not w.calls.get("model.encoder"):
        return None
    if importlib.util.find_spec("human_pose_estimation_tpu_torch.models.encoder_graph") is None:
        return None
    return 100.0 * w.calls.get("model.encoder.graph", 0) / w.calls["model.encoder"]
