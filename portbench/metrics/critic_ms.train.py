"""critic_ms.train: the host ms a step of the critic's loss, with the
gradient penalty's double backward, and its backward: ``critic.forward``
and ``critic.backward`` (``portbench/spans.py``)."""
from portbench.spans import per_step_ms


def read(ctx, trace):
    return per_step_ms(ctx, ["critic.forward", "critic.backward"])
