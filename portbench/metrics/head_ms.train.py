"""head_ms.train: the host ms a step of HMR 2.0's transformer-decoder head
and its 6D-to-matrix map: the ``model.head`` spans (``portbench/spans.py``).
None where the program ran no such span."""
from portbench.spans import per_step_ms, reduce


def read(ctx, trace):
    w = reduce(ctx)
    if w is None or not w.calls.get("model.head"):
        return None
    return per_step_ms(ctx, ["model.head"])
