"""launches_per_step.train: the device kernels launched in the traced
window over the training steps done in it (profiler)."""


def read(ctx, trace):
    steps = trace.counts.get("steps", 0)
    if steps <= 0 or trace.busy_s <= 0 or trace.launches <= 0:
        return None
    return trace.launches / steps
