"""Native-decoder input pipeline (counterpart of
``human_pose_estimation_tpu/data/native_pipeline.py``): npz shards -> the
C++ multithreaded JPEG / PNG decode and canvas fit
(``native/dataloader.cpp``) -> device augmentation, with a background
prefetch thread.

The framework's own native host pipeline, with no TensorFlow and no
OpenCV: the role tf.data's C++ runtime plays in the reference (ref
train.py:35-40, src/data_loader.py:87-93). Its geometry is
``data/npz_dataset``'s (the same shards, the same fit-to-canvas), so it
stands in for ``NpzImagePipeline`` wherever (GenBatch | HostBatch,
n_valid) pairs are consumed. The decoder links libjpeg and libpng: where
they cannot be built, the pipeline refuses to start.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..native import decode_fit_batch, get_dataloader
from ..train.step import HostBatch
from .pipeline import DevicePreprocessor, person_window_half

__all__ = ["NativeImagePipeline"]


class NativeImagePipeline:
    """Image pipeline with native batch decoding.

    Yields (GenBatch, n_valid), or (HostBatch, n_valid) with
    ``device_preprocess=False`` (for the fused training step). The host
    decodes batch k+1 in a prefetch thread while the device works on batch
    k.
    """

    def __init__(
        self,
        cfg: Config,
        files: Sequence[str],
        mode: str = "train",
        augment: Optional[bool] = None,
        canvas: int = 256,
        shuffle: Optional[bool] = None,
        repeat: Optional[bool] = None,
        seed: Optional[int] = None,
        device_preprocess: bool = True,
        num_threads: int = 0,
        prefetch: int = 2,
        device=None,
    ):
        """``device``: where the augmentation runs, ``cuda`` unless the
        caller asks for the CPU. The example order comes from a numpy
        ``RandomState(seed)``, as in the JAX pipeline; the augmentation
        draws from a ``torch.Generator`` on the device with the same seed.
        ``num_threads`` 0 lets the decoder use every core."""
        if get_dataloader() is None:
            raise RuntimeError(
                "native dataloader unavailable (no compiler / libjpeg); "
                "use data.npz_dataset.NpzImagePipeline instead"
            )
        self.cfg = cfg
        self.canvas = canvas
        self.batch_size = cfg.batch_size
        self.augment = (mode == "train") if augment is None else augment
        self.shuffle = (mode == "train") if shuffle is None else shuffle
        self.repeat = (mode == "train") if repeat is None else repeat
        self.num_threads = num_threads
        self.prefetch = max(1, prefetch)
        self.device_preprocess = device_preprocess
        self.prep = DevicePreprocessor(cfg, augment=self.augment, device=device) if device_preprocess else None
        self.window_half = person_window_half(cfg, self.augment)
        seed = cfg.seed if seed is None else seed
        self.generator = torch.Generator(device=self.prep.device).manual_seed(seed) if device_preprocess else None
        self.np_rng = np.random.RandomState(seed)

        self._examples: List[Tuple[bytes, bytes, np.ndarray, np.ndarray]] = []
        for path in files:
            z = np.load(path, allow_pickle=True)
            self._examples.extend(zip(z["jpeg"], z["png"], z["label"], z["center"]))
        if not self._examples:
            raise FileNotFoundError(f"no examples in npz shards {list(files)}")

    # ------------------------------------------------------------ host
    def _decode_batch(self, idx: np.ndarray) -> dict:
        """Decode len(idx) examples (zero-padded to batch_size) into one
        host batch with the native decoder."""
        n = len(idx)
        centers_src = np.stack([np.asarray(self._examples[i][3], np.int32) for i in idx])
        img, seg, hw, win_hw, off_yx, _scale, err = decode_fit_batch(
            [self._examples[i][0] for i in idx],
            [self._examples[i][1] for i in idx],
            self.canvas,
            num_threads=self.num_threads,
            centers=centers_src,
            window_half=self.window_half,
        )
        if (err != 0).any():
            bad = [int(i) for i, e in zip(idx, err) if e]
            raise ValueError(f"native decode failed for examples {bad}")
        label = np.zeros((n, 3, 19), np.float32)
        center = np.zeros((n, 2), np.int32)
        for k, i in enumerate(idx):
            lab = np.asarray(self._examples[i][2], np.float32)
            # float64 new / window ratios: the geometry of the OpenCV path
            # (_fit_to_canvas_np) bit for bit, truncation included; the
            # window offset is taken off before the rescale
            fy = hw[k, 0] / win_hw[k, 0]
            fx = hw[k, 1] / win_hw[k, 1]
            label[k] = np.stack([(lab[0] - off_yx[k, 1]) * fx, (lab[1] - off_yx[k, 0]) * fy, lab[2]], axis=0)
            c = self._examples[i][3]
            center[k] = (int((c[0] - off_yx[k, 1]) * fx), int((c[1] - off_yx[k, 0]) * fy))

        pad = self.batch_size - n
        if pad:

            def zpad(a):
                return np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)], axis=0)

            img, seg, label, center = map(zpad, (img, seg, label, center))
            hw = np.concatenate([hw, np.ones((pad, 2), np.int32)], axis=0)
        return {"image": img, "seg": seg, "hw": hw, "center": center, "label": label, "n": n}

    def _index_batches(self) -> Iterator[np.ndarray]:
        while True:
            order = np.arange(len(self._examples))
            if self.shuffle:
                self.np_rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                if len(idx) < self.batch_size and self.repeat:
                    continue  # drop the remainder while repeating (as tf.data)
                yield idx
            if not self.repeat:
                return

    def _producer(self, q: queue.Queue, stop: threading.Event):
        try:
            for idx in self._index_batches():
                if stop.is_set():
                    return
                q.put(self._decode_batch(idx))
            q.put(None)  # end of stream
        except BaseException as e:  # decode errors reach the consumer
            q.put(e)

    # ---------------------------------------------------------- public
    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        thread = threading.Thread(target=self._producer, args=(q, stop), daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                n = item.pop("n")
                if self.device_preprocess:
                    yield self.prep(item, self.generator), n
                else:
                    yield HostBatch(**item), n
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
