"""gen_ms.train: the host ms a step of the generator's forward, losses and
backward: ``gen.forward``, ``gen.losses`` and ``gen.backward``
(``portbench/spans.py``)."""
from portbench.spans import per_step_ms


def read(ctx, trace):
    return per_step_ms(ctx, ["gen.forward", "gen.losses", "gen.backward"])
