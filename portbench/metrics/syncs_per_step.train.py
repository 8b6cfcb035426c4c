"""syncs_per_step.train: the host-blocking runtime calls (stream, device
and event synchronisations, synchronous copies) launched inside the
traced window's ``step`` spans, a step (``portbench/spans.py``). A step
captured in one CUDA graph needs 0."""
from portbench.spans import syncs_per_step


def read(ctx, trace):
    return syncs_per_step(ctx)
