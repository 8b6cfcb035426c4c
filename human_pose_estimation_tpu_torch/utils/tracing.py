"""Named spans over the phases of the training loop, the training step, the
model and the chamfer entry points, recorded while a ``torch.profiler``
profile records.

``span(name)`` marks a block. While no profiler records it is one shared
no-op context: the cost is one flag check. While one records, the block is
kept in a bounded buffer in memory, on the clock that the profiler stamps
its host events with (``time.time_ns``), and is entered as
``torch.profiler.record_function(name)`` too, so that an exported Chrome
trace shows it. ``take()`` returns the kept spans, oldest first, and
empties the buffer; a span still open then is not returned. There is no
other switch: spans are recorded exactly when a profiler is.

A span's ``parent`` is the span that held it on the same thread (its index
in the list ``take()`` returns), or -1. The autograd engine launches the
backward's device work from a thread of its own, so device work belongs
to the spans that hold its launch in time, whatever the thread.

The names, nested as one dispatch of ``Trainer.train`` on the fused path
holds them (each span is one call; "per stage" spans come once per IEF
stage):

    loop.iter           one dispatch of Trainer.train
      loop.next         its batches and mocap drawn, the step's generator
      step              one training step (each of make_multi_step's k)
        step.prep       the batch copied to the device and augmented, its
                        silhouettes extracted (DevicePreprocessor)
        step.mocap      the mocap copied and posed by the body model
          model.smpl.graph  the pose replayed as a CUDA graph
                        (models/body_graph.py, forward only)
        gen.forward     the HMR forward
          model.encoder the encoder, ResNet or ViT (the ViT's
                        stochastic-depth masks drawn here first)
            model.encoder.graph  its forward replayed as a CUDA graph
                        (models/encoder_graph.py; the backward replays
                        inside gen.backward)
          model.ief     per stage, the IEF regressor
          model.head    per iteration, HMR 2.0's transformer-decoder head
                        and its 6D-to-matrix map, in place of model.ief
                        (the encoder is then the ViT)
          model.smpl    per stage, the body model and the projection
            model.smpl.graph  the body model's forward replayed as a
                        CUDA graph (models/body_graph.py; the backward
                        replays inside gen.backward)
        gen.losses      the per-stage losses
          chamfer.k2    each silhouette chamfer with its gradient (K2)
          critic.score  per stage, the critic on the stage's fakes
        gen.backward    the generator's gradients and their all-reduce
        gen.adam        the generator's update
        critic.forward  the critic's WGAN loss
          critic.penalty  the gradient penalty and its double backward
        critic.backward the critic's gradients and their all-reduce
        critic.adam     the critic's update
        step.metrics    the bone lengths and the global sums
      loop.fetch        the metrics' one device-to-host copy: the host
                        waits here for the device
      loop.log          the scalar summaries and the history

Evaluation runs ``model.*``, ``critic.score``, ``step.prep`` and
``chamfer.k1`` (each value-only chamfer) outside these. The count of a
name over a profile is its counter: steps, chamfer calls, metric copies.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, NamedTuple

from torch.autograd import profiler as _profiler

LIMIT = 1 << 16  # spans kept before take(); later ones are not recorded

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_records: list = []  # [name, parent, thread, start_ns, end_ns]; parent as an absolute index
_base = 0  # the absolute index of _records[0]


class Span(NamedTuple):
    name: str
    parent: int  # index in the list take() returned, -1 for none
    thread: int  # threading.get_ident() of the thread that ran the block
    start_ns: int  # time.time_ns() at entry
    end_ns: int  # time.time_ns() at exit


class _Recording:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            at = _base + len(_records)
            self.rec = [self.name, stack[-1] if stack else -1, threading.get_ident(), time.time_ns(), None]
            if len(_records) < LIMIT:
                _records.append(self.rec)
            else:
                at = -1
        stack.append(at)
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec[4] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """A context that records the block as ``name`` while a profiler
    records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name)


def take() -> List[Span]:
    """The spans recorded since the last call, oldest first, and an empty
    buffer."""
    global _records, _base
    with _lock:
        recs, base = _records, _base
        _records, _base = [], base + len(recs)
    out: List[Span] = []
    index = {}  # absolute index -> index in out
    for i, (name, parent, thread, start, end) in enumerate(recs):
        if end is None:
            continue
        index[base + i] = len(out)
        out.append(Span(name, index.get(parent, -1), thread, start, end))
    return out
