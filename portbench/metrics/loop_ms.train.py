"""loop_ms.train: the training loop's own host time a step: each
``loop.iter`` span of the traced window less the ``step`` and
``loop.fetch`` spans it holds (drawing the batches, the generator, the
scalar summaries), over the steps it holds (``portbench/spans.py``)."""
from portbench.spans import loop_ms


def read(ctx, trace):
    return loop_ms(ctx)
