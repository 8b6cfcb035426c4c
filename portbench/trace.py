"""The traced window of a ``--trace 1`` run and its reduction.

A driver calls ``Tracer.tick(**counters)`` at the boundaries of its units
of work (a step, a batch) with its running counts. The traced part sits
at the end of the window: at the first tick ``length_s + label_s +
SPARE_S`` seconds before the window's end (the spare covers the
profiler's own start-up) the tracer starts ``torch.profiler`` with
device activity only, the traced window, and stops it at the first tick
``length_s`` later; the counts between the two ticks are the traced
window's work. It then traces ``label_s`` more with the host's operations
recorded too, only to name the idle gaps: recording every host operation
slows a launch-bound program by half, so no metric reads that part. Each
start and stop waits for the device first, so no work is in flight across
them. The window's lead, from its first tick to the trace's start, runs
with no profiler: its counts and seconds give the rates that the
profiler's own cost would bias.

``summarize`` reduces a trace: the seconds in which a kernel, copy or set
ran on the device (the union of their intervals, so overlaps count once),
the device time and launch count of each kernel name, and the idle gaps
between device intervals, each named by the innermost host operation
running at its midpoint.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host-clock length of the traced window
    busy_s: float  # union of the device's kernel, copy and set intervals
    kernel_s: Dict[str, float]  # kernel name -> device seconds
    kernel_n: Dict[str, int]  # kernel name -> launches
    device_ops: List[Tuple[str, float]]  # the 10 names with most device time
    idle_gaps: List[Tuple[str, float]]  # idle seconds by host operation, the 10 largest
    counts: Dict[str, float]  # the driver's counters over the window
    lead_s: float = 0.0  # host-clock length of the untraced lead
    lead_counts: Dict[str, float] = dataclasses.field(default_factory=dict)  # the counters over the lead

    @property
    def launches(self) -> int:
        return sum(self.kernel_n.values())

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose names hold one of
        ``names`` as a whole identifier."""
        pats = [re.compile(r"(?<![A-Za-z0-9_])" + re.escape(n) + r"(?![A-Za-z0-9_])") for n in names]
        s, n = 0.0, 0
        for k, v in self.kernel_s.items():
            if any(p.search(k) for p in pats):
                s += v
                n += self.kernel_n[k]
        return s, n


SPARE_S = 4.0


class Tracer:
    def __init__(self, enabled: bool, window_s: float, length_s: float, device: torch.device, label_s: float = 1.0):
        self.enabled = enabled
        self.after_s = max(0.0, window_s - length_s - label_s - SPARE_S)
        self.length_s, self.label_s = length_s, label_s
        self.device = device
        self.t0: Optional[float] = None
        self.phase = 0  # 0 before, 1 the traced window, 2 the labelling trace, 3 done
        self.prof = self.labels = None
        self.t_start = self.t_stop = self.t_labels = None
        self.t_first: Optional[float] = None
        self.c_first: Dict[str, float] = {}
        self.c_start: Dict[str, float] = {}
        self.c_stop: Dict[str, float] = {}
        self._summary: Optional[TraceSummary] = None

    def begin(self) -> None:
        """The measured window opens."""
        self.t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU] if host or self.device.type != "cuda" else [])
        acts += [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        self._sync()
        prof = profile(activities=acts)
        prof.start()
        return prof

    def tick(self, **counters) -> None:
        if not self.enabled or self.t0 is None or self.phase == 3:
            return
        now = time.perf_counter()
        if self.t_first is None:
            self.t_first, self.c_first = now, dict(counters)
        if self.phase == 0 and now - self.t0 >= self.after_s:
            self.prof = self._profile(host=False)
            self.c_start, self.t_start, self.phase = dict(counters), time.perf_counter(), 1
        elif self.phase == 1 and now - self.t_start >= self.length_s:
            self._stop(counters)
            self.labels, self.t_labels, self.phase = self._profile(host=True), time.perf_counter(), 2
        elif self.phase == 2 and now - self.t_labels >= self.label_s:
            self._sync()
            self.labels.stop()
            self.phase = 3

    def _stop(self, counters) -> None:
        self._sync()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self.c_stop = dict(counters)

    def close(self, **counters) -> None:
        """The window closed: stop a profiler still running."""
        if self.phase == 1:
            self._stop(counters)
        elif self.phase == 2:
            self._sync()
            self.labels.stop()
        self.phase = 3

    def summary(self) -> Optional[TraceSummary]:
        """The traced window reduced (once), or None when it never opened;
        its idle gaps named from the labelling trace, when that saw the
        device work."""
        if self.prof is None or self.t_stop is None:
            return None
        if self._summary is None:
            counts = {k: v - self.c_start.get(k, 0) for k, v in self.c_stop.items() if isinstance(v, (int, float))}
            self._summary = summarize(self.prof, self.t_stop - self.t_start, counts)
            self._summary.lead_s = self.t_start - self.t_first
            self._summary.lead_counts = {k: v - self.c_first.get(k, 0) for k, v in self.c_start.items()
                                         if isinstance(v, (int, float))}
            if self.labels is not None:
                self._summary.idle_gaps = summarize(self.labels, 0.0, {}).idle_gaps or self._summary.idle_gaps
        return self._summary


def _events(prof):
    """(device intervals [(start_ns, end_ns, name, is_kernel)], host
    operations [(start_ns, end_ns, name)]) from the raw trace."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or "annotation" in kind:
                continue  # a record_function range's span on the device, not work
            start = e.start_ns()
            name = e.name()
            is_kernel = kind == "kernel" if kind else not name.startswith(("Memcpy", "Memset"))
            dev.append((start, start + e.duration_ns(), name, is_kernel))
        elif kind in ("cpu_op", "") and not e.is_user_annotation():
            start = e.start_ns()
            host.append((start, start + e.duration_ns(), e.name()))
    return dev, host


def summarize(prof, window_s: float, counts: Dict[str, float]) -> TraceSummary:
    dev, host = _events(prof)
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    op_s: Dict[str, float] = {}
    for s, e, name, is_kernel in dev:
        op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e9
        if is_kernel:
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e9
            kernel_n[name] = kernel_n.get(name, 0) + 1
    # busy: the union of the device intervals; the gaps between them
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _, _ in sorted(dev):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps.append((cur_e, s))
                busy += (cur_e - cur_s) / 1e9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += (cur_e - cur_s) / 1e9
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        label, best = "host outside any operation", None
        i = bisect.bisect_right(starts, mid)
        # the innermost operation holding the midpoint: the latest-started one
        # that has not ended (operations nest)
        for j in range(i - 1, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                best = host[j]
                break
        if best is not None:
            label = best[2]
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e9
    top = lambda d: sorted(((k[:160], v) for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return TraceSummary(
        window_s=window_s, busy_s=busy, kernel_s=kernel_s, kernel_n=kernel_n,
        device_ops=top(op_s), idle_gaps=top(idle), counts=counts,
    )
