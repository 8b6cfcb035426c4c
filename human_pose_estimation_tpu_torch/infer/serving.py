"""Serving layer: request microbatching around the Predictor (counterpart
of ``human_pose_estimation_tpu/infer/serving.py``).

``BatchingPredictor`` queues single-image requests from many threads,
flushes a padded batch when it is full or when its oldest request has
waited ``max_latency_ms``, and resolves one future per request. One
dispatcher thread does all device work. Plain threading; callers put it
behind whatever front end they use (``infer/http_server.py`` is one).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch


class BatchingPredictor:
    """Microbatching front end over a Predictor (or any object with
    ``batch_size`` and ``predict``, such as ``ExportedPredictor``).

    submit(image) -> Future resolving to the per-image result dict (the
    keys of ``Predictor.predict``, the leading batch dim stripped).

    * A batch flushes when ``batch_size`` requests are queued or the oldest
      waiting one has waited ``max_latency_ms``.
    * One dispatcher thread does all device work, on the CUDA stream that
      was current where the BatchingPredictor was built (a thread's
      current stream is its own), so submit() is safe from any thread.
    * ``pipeline_depth`` batches stay in flight (dispatched, not yet
      fetched) when the predictor has ``predict_async`` /
      ``predict_fetch``: batch k+1's stacking and pinned upload overlap
      batch k's compute, since ``predict_async`` does not wait for the
      device. Results are fetched eagerly whenever the request queue is
      empty, so light load sees no added latency. A predictor without the
      async API is served blocking at fetch, in the same FIFO order.
    * ``stats`` counts requests, batches and padded slots.
    """

    def __init__(
        self,
        predictor,
        max_latency_ms: float = 5.0,
        queue_capacity: int = 4096,
        pipeline_depth: int = 1,
    ):
        self.predictor = predictor
        self.batch_size = predictor.batch_size
        self.max_latency = max_latency_ms / 1000.0
        self.pipeline_depth = max(1, int(pipeline_depth))
        device = torch.device(getattr(predictor, "device", "cpu"))
        self._stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self._queue: queue.Queue = queue.Queue(maxsize=queue_capacity)
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0}
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- public
    def submit(self, image: np.ndarray) -> "Future[Dict[str, np.ndarray]]":
        """Enqueue one (H, W, 3) image (uint8 preferred); returns a Future."""
        if self._stop.is_set():
            raise RuntimeError("BatchingPredictor is closed")
        fut: Future = Future()
        self._queue.put((np.asarray(image), fut))
        return fut

    def predict_single_image(self, image) -> Dict[str, np.ndarray]:
        """Blocking convenience wrapper."""
        return self.submit(image).result()

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Serve what is queued, stop the dispatcher, and fail every future
        left behind (a submit() racing the dispatcher's last look at the
        queue)."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("BatchingPredictor closed"))

    # ------------------------------------------------------- dispatcher
    def _collect(self):
        """Block for the first request, then gather until the batch is full
        or the first request's deadline passes."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_latency
        while len(items) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _dispatch_loop(self):
        stream = torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()
        with stream:
            self._serve()

    def _serve(self):
        dispatch = getattr(self.predictor, "predict_async", None)
        fetch = getattr(self.predictor, "predict_fetch", None)
        if dispatch is None or fetch is None:
            dispatch = lambda images: images  # noqa: E731
            fetch = self.predictor.predict

        inflight: deque = deque()  # (handle, items) in dispatch order

        def drain_oldest():
            handle, items = inflight.popleft()
            try:
                out = fetch(handle)
            except Exception as exc:  # every waiting caller gets the error
                for _, fut in items:
                    fut.set_exception(exc)
                return
            self.stats["requests"] += len(items)
            self.stats["batches"] += 1
            self.stats["padded_slots"] += self.batch_size - len(items)
            for i, (_, fut) in enumerate(items):
                fut.set_result({k: v[i] for k, v in out.items()})

        while True:
            # fetch when idle (no latency added under light load) or when
            # the pipeline is full
            while inflight and (len(inflight) >= self.pipeline_depth or self._queue.empty()):
                drain_oldest()
            items = self._collect()
            if not items:
                if self._stop.is_set() and self._queue.empty():
                    while inflight:
                        drain_oldest()
                    return
                continue
            try:
                handle = dispatch(np.stack([im for im, _ in items]))
            except Exception as exc:
                for _, fut in items:
                    fut.set_exception(exc)
                continue
            inflight.append((handle, items))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
