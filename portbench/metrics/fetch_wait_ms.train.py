"""fetch_wait_ms.train: the host ms a step in ``loop.fetch``, the loop's one
device-to-host copy of the metrics, where the host waits for the device
to finish the step (``portbench/spans.py``)."""
from portbench.spans import per_step_ms


def read(ctx, trace):
    return per_step_ms(ctx, ["loop.fetch"])
