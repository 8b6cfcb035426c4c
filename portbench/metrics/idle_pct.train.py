"""idle_pct.train: the share of the traced window in which no kernel, copy or
set ran on the device (profiler)."""
from portbench.readers import idle_pct


def read(ctx, trace):
    return idle_pct(trace)
