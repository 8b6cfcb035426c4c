"""adam_ms.train: the host ms a step of the two Adam updates: ``gen.adam``
and ``critic.adam`` (``portbench/spans.py``)."""
from portbench.spans import per_step_ms


def read(ctx, trace):
    return per_step_ms(ctx, ["gen.adam", "critic.adam"])
