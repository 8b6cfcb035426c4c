"""Grain input pipeline over npz shards (counterpart of
``human_pose_estimation_tpu/data/grain_pipeline.py``).

A fourth host path (``Config.input_pipeline='grain'``) with the (GenBatch,
n_valid) contract of the tf.data, npz and native pipelines, on
``grain.MapDataset``:

* a seeded shuffle that changes every epoch (grain's stateless shuffle);
* a resumable position: ``get_state`` / ``set_state`` capture where the
  stream is, and the trainer keeps it beside each checkpoint;
* decoding in worker processes (``num_workers > 0``, grain's
  ``mp_prefetch``);
* per-rank example sharding for data parallelism (``shard_by_host``), an
  index slice.

grain is imported when a pipeline is built, never with this module (the
card's machine has none; there the constructor raises the ImportError).
The augmentation runs on the device in the same ``DevicePreprocessor`` as
the other pipelines, drawing from a generator seeded from (seed, batch
count) (``train.state.step_generator``), as the JAX pipeline folds its key
on the count: a resumed stream draws the augmentation of the straight one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..parallel import mesh as pmesh
from ..train.state import step_generator
from .npz_dataset import _fit_to_canvas_np
from .pipeline import DevicePreprocessor, person_window_half

__all__ = ["GrainImagePipeline", "NpzShardSource"]


class NpzShardSource:
    """Random-access grain source over npz shards (the layout of
    ``data/npz_dataset.py``: JPEG / PNG byte arrays, labels, centres).

    Shards are opened when first read and cached per process, so the
    source pickles cheaply into grain's workers (only the paths and
    offsets cross the process boundary)."""

    def __init__(self, files: Sequence[str]):
        self.files = list(files)
        if not self.files:
            raise FileNotFoundError("no npz shards given")
        self._lengths: List[int] = []
        for path in self.files:
            with np.load(path, allow_pickle=True) as z:
                self._lengths.append(int(z["label"].shape[0]))
        self._offsets = np.cumsum([0] + self._lengths)
        self._cache: Dict[int, Any] = {}

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_cache"] = {}
        return state

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _shard(self, i: int):
        z = self._cache.get(i)
        if z is None:
            with np.load(self.files[i], allow_pickle=True) as data:
                z = {k: data[k] for k in ("jpeg", "png", "label", "center")}
            self._cache[i] = z
        return z

    def __getitem__(self, index: int) -> Tuple[bytes, bytes, np.ndarray, np.ndarray]:
        index = int(index)
        if index < 0:
            index += len(self)
        s = int(np.searchsorted(self._offsets, index, side="right") - 1)
        z = self._shard(s)
        j = index - int(self._offsets[s])
        return z["jpeg"][j], z["png"][j], z["label"][j], z["center"][j]


def _decode_example(example, canvas: int, window_half=None) -> Dict[str, np.ndarray]:
    """Decode one example on the host and fit it into the fixed canvas: one
    ``HostBatch`` row."""
    import cv2

    jpeg, png, label, center = example
    img = cv2.cvtColor(cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    seg = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_GRAYSCALE)
    img_c, seg_c, label, center, hw = _fit_to_canvas_np(img, seg, label, center, canvas, window_half=window_half)
    return {
        "image": img_c,
        "seg": seg_c,
        "label": label,
        "center": np.asarray(center, np.int32),
        "hw": np.asarray(hw, np.int32),
    }


def _pad_row(canvas: int) -> Dict[str, np.ndarray]:
    """An empty example with a 1x1 extent (the padding of a last partial
    batch, as the npz and native pipelines pad)."""
    return {
        "image": np.zeros((canvas, canvas, 3), np.uint8),
        "seg": np.zeros((canvas, canvas, 1), np.uint8),
        "label": np.zeros((3, 19), np.float32),
        "center": np.zeros(2, np.int32),
        "hw": np.ones(2, np.int32),
    }


class GrainImagePipeline:
    """npz shards -> (worker-process) host decode -> device augmentation;
    yields (GenBatch, n_valid) like ``ImagePipeline``.

    One live iterator per pipeline: ``__iter__`` reads the same grain
    iterator every time, so ``get_state`` / ``set_state`` always refer to
    the stream being consumed."""

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
        num_workers: int = 0,
        shard_by_host: bool = False,
        read_threads: int = 2,
        device=None,
    ):
        """``shard_by_host``: under a process group of more than one rank,
        each rank reads every R-th example from its rank on (before the
        shuffle), and ``batch_size`` is the per-rank batch. ``device``:
        where the augmentation runs, ``cuda`` unless the caller asks for
        the CPU."""
        import grain

        self.cfg = cfg
        self.canvas = canvas
        self.batch_size = cfg.batch_size
        self.augment = (mode == "train") if augment is None else augment
        self.shuffle = (mode == "train") if shuffle is None else shuffle
        self.repeat = (mode == "train") if repeat is None else repeat
        self.prep = DevicePreprocessor(cfg, augment=self.augment, device=device)
        window_half = person_window_half(cfg, self.augment)
        self.seed = cfg.seed if seed is None else seed
        self._step = 0

        ds = grain.MapDataset.source(NpzShardSource(files)).seed(self.seed)
        if shard_by_host and pmesh.world_size() > 1:
            ds = ds.slice(slice(pmesh.rank(), None, pmesh.world_size()))
        if self.shuffle:
            ds = ds.shuffle()  # stateless; reshuffles every epoch
        if self.repeat:
            ds = ds.repeat()
        ds = ds.map(lambda ex: _decode_example(ex, canvas, window_half))
        # grain's default batch_fn stacks the dict rows
        ds = ds.batch(self.batch_size, drop_remainder=self.repeat)
        it_ds = ds.to_iter_dataset(grain.ReadOptions(num_threads=read_threads, prefetch_buffer_size=8))
        if num_workers > 0:
            it_ds = it_ds.mp_prefetch(grain.MultiprocessingOptions(num_workers=num_workers))
        self._it = iter(it_ds)

    # ------------------------------------------------------ checkpointing
    def get_state(self) -> Dict[str, Any]:
        """The resumable position: grain's iterator state and the batch
        count that seeds the augmentation."""
        return {"grain": self._it.get_state(), "step": self._step}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._it.set_state(state["grain"])
        self._step = int(state["step"])

    # ------------------------------------------------------------- stream
    def __iter__(self):
        for host in self._it:
            n = int(host["image"].shape[0])
            if n < self.batch_size:  # the tail of a pass that does not repeat
                pad = _pad_row(self.canvas)
                host = {k: np.concatenate([host[k], np.stack([pad[k]] * (self.batch_size - n))]) for k in host}
            gen = step_generator(self.seed, self._step, self.prep.device)
            self._step += 1
            yield self.prep(host, gen), n
