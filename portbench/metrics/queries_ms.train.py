"""queries_ms.train: the host ms a step of the Human Prediction Head's
camera-ray embedding and its gather of the person queries: the
``model.camera`` and ``model.queries`` spans (``portbench/spans.py``).
None where the program ran neither span."""
from portbench.spans import per_step_ms, reduce


def read(ctx, trace):
    w = reduce(ctx)
    if w is None or not (w.calls.get("model.camera") or w.calls.get("model.queries")):
        return None
    return per_step_ms(ctx, ["model.camera", "model.queries"])
