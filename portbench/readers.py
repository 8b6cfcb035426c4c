"""What the per-layer metric readers share. Each reader takes the run's
context and the traced window's summary and returns a number, or None
when the window holds nothing to read: a reader never reports 0 for a
share it could not measure."""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from portbench import flops, roofline


def idle_pct(trace) -> Optional[float]:
    """Share of the traced window in which nothing ran on the device."""
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(ctx, trace, per_image: float) -> Optional[float]:
    """The model's operations of the images done in the window's untraced
    lead over its seconds and the dense bf16 peak: the profiler's own cost
    slows a launch-bound loop, so the traced part is not read."""
    images = trace.lead_counts.get("images", 0)
    if images <= 0 or trace.lead_s <= 0 or trace.busy_s <= 0:  # no device, no device metric
        return None
    return 100.0 * images * per_image / trace.lead_s / roofline.PEAK_BF16_FLOPS


def train_image_flops(ctx) -> float:
    return flops.train_flops(ctx.config)


def kernel_names(path: str) -> List[str]:
    """The kernel names listed one per line in ``path`` (# comments)."""
    lines = Path(path).read_text().splitlines()
    return [ln.split("#", 1)[0].strip() for ln in lines if ln.split("#", 1)[0].strip()]


def chamfer_roofline_pct(ctx, trace, names: List[str], with_grad: bool) -> Optional[float]:
    """The chamfer calls' bound (their inputs' work) over the device time of
    the named kernels in the traced window."""
    calls = ctx.extra.get("chamfer_calls")
    seconds, _ = trace.kernel_seconds(names)
    if not calls or seconds <= 0:
        return None
    cfg = ctx.config
    bound = sum(roofline.chamfer_bound_s(valid, n, cfg["max_silhouette_points"], cfg["num_verts"], with_grad)
                for valid, n in calls)
    return 100.0 * bound / seconds
