"""prep_ms.train: the host ms a step of the step's input on the device:
``step.prep`` (the canvases copied, augmented, the silhouettes extracted)
and ``step.mocap`` (the mocap copied and posed) (``portbench/spans.py``)."""
from portbench.spans import per_step_ms


def read(ctx, trace):
    return per_step_ms(ctx, ["step.prep", "step.mocap"])
