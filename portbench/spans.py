"""The program's own spans over the traced window of a ``--trace 1`` run,
put together with the window's device activity, for the readers of the
training loop's phases.

The port keeps a named span for each phase of its loop, step and model
while a profiler records (``human_pose_estimation_tpu_torch/utils/
tracing.py``, whose docstring lists the names), on the clock that the
profiler stamps its events with; ``tracing.take()`` hands them over.
``reduce(ctx)`` takes them once, and the device-only profile that the
tracer keeps (``ctx.tracer.prof``). It keeps the spans that lie within the
traced window, from the tracer's start to its stop (the labelling trace's
spans fall outside), and computes:

* each name's calls and its total and self host time (self: less the
  spans it holds directly);
* each device-idle gap put down to the innermost span holding its
  midpoint;
* each kernel, copy and set put down to the innermost span holding its
  launch: the runtime call that carries its correlation id;
* each host-blocking runtime call put down to the innermost span holding
  it.

Per step means over the ``step`` spans of the window. The result is kept
in ``ctx.extra``, and the table of idle time by span is printed once to
standard error. A program without spans, or a window without a ``step``
span, gives None: every reader then returns None.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import harness as H
from portbench import roofline

OUTSIDE = "outside any span"
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
# runtime calls after which the host has waited for the device
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                   "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"})

# (name, parent index or -1, thread, start_ns, end_ns), as tracing.take() gives them
SpanRec = Tuple[str, int, int, int, int]
# (start_ns, end_ns, name, correlation id)
Event = Tuple[int, int, str, int]


@dataclasses.dataclass
class Window:
    spans: List[SpanRec]  # every span taken; those in the window are ``inside``
    inside: List[int]
    calls: Dict[str, int]  # over the window's spans
    total_ms: Dict[str, float]
    self_ms: Dict[str, float]
    idle_ms: Dict[str, float]  # device-idle time by the innermost span at each gap's midpoint
    device_ms: Dict[str, float]  # device time by the innermost span at each launch
    syncs: Dict[str, int]  # host-blocking runtime calls by the innermost span at their start
    step_syncs: int  # those of them inside a step span
    runtime_calls: int  # runtime calls in the window: none means the profile recorded none
    early: Dict[str, int]  # device work that started before its span did, by span
    unlaunched: int  # device work whose launch was not found

    @property
    def steps(self) -> int:
        return self.calls.get("step", 0)


class _Innermost:
    """The innermost span holding a time: per thread the latest-started span
    that began at or before it, or its nearest ancestor still open then
    (one thread's spans nest); of the threads' answers the latest-started."""

    def __init__(self, spans: Sequence[SpanRec]):
        self.spans = spans
        by: Dict[int, List[int]] = {}
        for i in sorted(range(len(spans)), key=lambda i: spans[i][3]):
            by.setdefault(spans[i][2], []).append(i)
        self.threads = [([spans[i][3] for i in idx], idx) for idx in by.values()]

    def __call__(self, t: int) -> int:
        best = -1
        for starts, idx in self.threads:
            k = bisect.bisect_right(starts, t) - 1
            j = idx[k] if k >= 0 else -1
            while j >= 0 and self.spans[j][4] < t:
                j = self.spans[j][1]
            if j >= 0 and (best < 0 or self.spans[j][3] > self.spans[best][3]):
                best = j
        return best


def _add(d: Dict, k, v) -> None:
    d[k] = d.get(k, 0) + v


def reduce_events(spans: Sequence[SpanRec], device: Sequence[Event], runtime: Sequence[Event],
                  lo_ns: int, hi_ns: int) -> Window:
    """The window [``lo_ns``, ``hi_ns``]'s spans with the device intervals
    and runtime calls of its profile."""
    spans = list(spans)
    inside = [i for i, s in enumerate(spans) if s[3] >= lo_ns and s[4] <= hi_ns]
    calls: Dict[str, int] = {}
    total: Dict[str, float] = {}
    own: Dict[str, float] = {}
    held = [0] * len(spans)
    for s in spans:
        if s[1] >= 0:
            held[s[1]] += s[4] - s[3]
    for i in inside:
        name, _, _, start, end = spans[i]
        _add(calls, name, 1)
        _add(total, name, (end - start) / 1e6)
        _add(own, name, (end - start - held[i]) / 1e6)
    at = _Innermost(spans)
    label = lambda j: spans[j][0] if j >= 0 else OUTSIDE  # noqa: E731

    idle: Dict[str, float] = {}
    cur = None
    for s, e, _, _ in sorted(device):
        if cur is not None and s > cur:
            _add(idle, label(at((cur + s) // 2)), (s - cur) / 1e6)
        cur = e if cur is None else max(cur, e)

    launched = {c: s for s, _, _, c in runtime if c}
    dev_ms: Dict[str, float] = {}
    early: Dict[str, int] = {}
    unlaunched = 0
    for s, e, _, c in device:
        if c not in launched:
            unlaunched += 1
            continue
        j = at(launched[c])
        _add(dev_ms, label(j), (e - s) / 1e6)
        if j >= 0 and s < spans[j][3]:
            _add(early, label(j), 1)

    def in_step(j):
        while j >= 0 and spans[j][0] != "step":
            j = spans[j][1]
        return j >= 0

    syncs: Dict[str, int] = {}
    step_syncs = 0
    for s, _, name, _ in runtime:
        if name in SYNCS:
            j = at(s)
            _add(syncs, label(j), 1)
            step_syncs += in_step(j)
    n_runtime = sum(1 for s, _, _, _ in runtime if lo_ns <= s <= hi_ns)
    return Window(spans, inside, calls, total, own, idle, dev_ms, syncs, step_syncs, n_runtime, early, unlaunched)


def profile_events(prof) -> Tuple[List[Event], List[Event]]:
    """(device intervals, runtime calls) of a ``torch.profiler`` profile, with
    their correlation ids; the device's annotation rows are no work. Where
    the events carry no activity type (older torch), a runtime call is a
    host event named by the CUDA runtime or driver API (``cu...``)."""
    import torch

    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or "annotation" in kind:
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id()))
        elif not e.is_user_annotation() and (kind in RUNTIME_KINDS if kind else e.name().startswith("cu")):
            runtime.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id()))
    return device, runtime


def reduce(ctx) -> Optional[Window]:
    """The traced window's spans, reduced once per run; None without a
    traced window, without the program's spans, or without a step span."""
    if "spans" in ctx.extra:
        return ctx.extra["spans"]
    tracer = getattr(ctx, "tracer", None)
    prof = getattr(tracer, "prof", None)
    if prof is None or getattr(tracer, "t_stop", None) is None:
        return None
    try:
        from human_pose_estimation_tpu_torch.utils import tracing
    except ImportError:  # a program without spans
        ctx.extra["spans"] = None
        return None
    offset = time.time_ns() - time.perf_counter_ns()  # the tracer's clock onto the spans'
    lo, hi = int(tracer.t_start * 1e9) + offset, int(tracer.t_stop * 1e9) + offset
    device, runtime = profile_events(prof)
    w = reduce_events(tracing.take(), device, runtime, lo, hi)
    if w.steps == 0:
        w = None
    else:
        _print(w)
    ctx.extra["spans"] = w
    return w


def _print(w: Window) -> None:
    idle = sum(w.idle_ms.values())
    named = idle - w.idle_ms.get(OUTSIDE, 0.0)
    step = w.total_ms.get("step", 0.0)
    H.log(f"[spans] {w.steps} steps in the traced window; device idle {idle:.3f} ms, "
          f"{100 * named / idle if idle else 0:.1f}% of it inside a span; the step's phases cover "
          f"{100 * (1 - w.self_ms.get('step', 0.0) / step) if step else 0:.1f}% of its host time; "
          f"{w.runtime_calls} runtime calls, {w.unlaunched} device intervals without a launch, "
          f"device work before its span's start: {w.early or 'none'}")
    H.log("[spans] name: calls, host ms total | self, device-idle ms, device ms launched, syncs")
    for name in sorted(set(w.calls) | set(w.idle_ms), key=lambda n: -w.idle_ms.get(n, 0.0)):
        H.log(f"[spans]   {name}: {w.calls.get(name, 0)}, {w.total_ms.get(name, 0.0):.3f} | "
              f"{w.self_ms.get(name, 0.0):.3f}, {w.idle_ms.get(name, 0.0):.3f}, {w.device_ms.get(name, 0.0):.3f}, "
              f"{w.syncs.get(name, 0)}")


def per_step_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """The host ms a step of the window's spans of ``names``."""
    w = reduce(ctx)
    if w is None:
        return None
    return sum(w.total_ms.get(n, 0.0) for n in names) / w.steps


def loop_ms(ctx) -> Optional[float]:
    """The loop's own host ms a step: each ``loop.iter`` of the window less
    the ``step`` and ``loop.fetch`` spans it holds, over the steps they
    hold."""
    w = reduce(ctx)
    if w is None:
        return None
    own, steps = 0, 0
    iters = {i for i in w.inside if w.spans[i][0] == "loop.iter"}
    for i in iters:
        own += w.spans[i][4] - w.spans[i][3]
    for s in w.spans:
        if s[1] in iters and s[0] in ("step", "loop.fetch"):
            own -= s[4] - s[3]
            steps += s[0] == "step"
    return own / 1e6 / steps if steps else None


def syncs_per_step(ctx) -> Optional[float]:
    """Host-blocking runtime calls inside the window's ``step`` spans, a
    step; None when the profile recorded no runtime call."""
    w = reduce(ctx)
    if w is None or w.runtime_calls == 0:
        return None
    return w.step_syncs / w.steps


def chamfer_call_roofline_pct(ctx, span: str, with_grad: bool) -> Optional[float]:
    """The chamfer calls' bound (``readers.chamfer_roofline_pct``'s, from
    their inputs) over the device time of all the work launched inside the
    window's ``span`` spans: the kernels and the wrapper's operations."""
    w = reduce(ctx)
    calls = ctx.extra.get("chamfer_calls")
    if w is None or not calls or not w.calls.get(span) or w.device_ms.get(span, 0.0) <= 0:
        return None
    cfg = ctx.config
    bound = sum(roofline.chamfer_bound_s(valid, n, cfg["max_silhouette_points"], cfg["num_verts"], with_grad)
                for valid, n in calls)
    # the calls the training window counted and the spans of the window are the same
    # steps' calls; the mean bound a call holds where they differ
    bound *= w.calls[span] / len(calls)
    return 100.0 * bound / (w.device_ms[span] / 1e3)
