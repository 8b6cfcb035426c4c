"""Native (C++) host components, built at first use with g++ (counterpart
of ``human_pose_estimation_tpu/native/__init__.py``).

Two libraries, loaded through ctypes:

* ``rasterizer.cpp`` — the z-buffered mesh rasterizer behind
  ``viz/renderer.rasterize_mesh`` (flat shading); it needs only g++.
* ``dataloader.cpp`` — multithreaded JPEG / PNG batch decode and
  fit-to-canvas for ``data/native_pipeline.py``; it links libjpeg and
  libpng, so it builds only where their headers are installed.

Each library is compiled once per source version into ``build/native/``
under the repository root (``lib<name>_<hash>.so``, written under a
temporary name and renamed into place), never into the package. A build
that fails is remembered: the getters return None and callers take their
Python path (the renderer) or refuse (the native pipeline).
``BUILD_SECONDS`` and ``BUILD_LOG`` hold each g++ call's wall time and
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "BUILD_LOG",
    "BUILD_SECONDS",
    "decode_fit_batch",
    "get_dataloader",
    "get_rasterizer",
    "rasterize_native",
]

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LINK = {"dataloader": ("-ljpeg", "-lpng", "-lpthread")}

BUILD_SECONDS = {}  # library name -> wall time of the g++ call that built it
BUILD_LOG = {}  # library name -> g++'s output, or why the build failed

_lock = threading.Lock()
_libs = {}
_failed = set()


def _lib_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(_FLAGS + _LINK.get(name, ()))
    return _BUILD_DIR / f"lib{name}_{hashlib.sha1(src + flags.encode()).hexdigest()[:12]}.so"


def _load(name: str) -> Optional[ctypes.CDLL]:
    """Build ``native/<name>.cpp`` if this version is not built yet, and
    load it; None when g++ or a library it links is missing."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _failed:
            return None
        out = _lib_path(name)
        try:
            if not out.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = ["g++", *_FLAGS, str(_SRC_DIR / f"{name}.cpp"), "-o", str(tmp), *_LINK.get(name, ())]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                BUILD_SECONDS[name] = time.perf_counter() - t0
                BUILD_LOG[name] = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode})")
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            lib = ctypes.CDLL(str(out))
        except Exception as e:  # no compiler, no libjpeg / libpng, a failed load
            BUILD_LOG.setdefault(name, "")
            BUILD_LOG[name] += f"{type(e).__name__}: {e}"
            _failed.add(name)
            return None
        _libs[name] = lib
        return lib


def get_rasterizer() -> Optional[ctypes.CDLL]:
    """The rasterizer library, built on first use; None when it cannot be
    built."""
    lib = _load("rasterizer")
    if lib is None:
        return None
    if not getattr(lib, "_hpe_configured", False):
        dp = ctypes.POINTER(ctypes.c_double)
        lib.rasterize_mesh.restype = None
        lib.rasterize_mesh.argtypes = [
            dp,  # verts
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),  # faces
            ctypes.c_int64,
            ctypes.c_int64,  # height
            ctypes.c_int64,  # width
            ctypes.c_double,  # focal
            ctypes.c_double,  # cx
            ctypes.c_double,  # cy
            dp,  # color
            dp,  # light_dir
            ctypes.c_double,  # ambient
            dp,  # img
            ctypes.POINTER(ctypes.c_uint8),  # mask
        ]
        lib._hpe_configured = True
    return lib


def rasterize_native(
    verts: np.ndarray,
    faces: np.ndarray,
    height: int,
    width: int,
    focal: float,
    center: np.ndarray,
    color: np.ndarray,
    light_dir: np.ndarray,
    ambient: float,
    background: Optional[np.ndarray] = None,
):
    """The C++ rasterizer under ``viz.renderer.rasterize_mesh``'s contract
    (flat shading): (image (H, W, 3) float64 in [0, 1], mask (H, W) bool),
    or None when the library is unavailable."""
    lib = get_rasterizer()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    # the library indexes these buffers unchecked
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"verts and faces must be (V, 3) and (F, 3), got {verts.shape} and {faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= verts.shape[0]):
        raise ValueError(f"faces index vertices outside [0, {verts.shape[0]})")
    if background is not None and np.shape(background) != (height, width, 3):
        raise ValueError(f"background must be ({height}, {width}, 3), got {np.shape(background)}")
    img = (
        np.array(background, np.float64, order="C")
        if background is not None
        else np.ones((height, width, 3), np.float64)
    )
    mask = np.zeros((height, width), np.uint8)
    color = np.ascontiguousarray(color, np.float64)
    light = np.ascontiguousarray(light_dir, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rasterize_mesh(
        verts.ctypes.data_as(dp),
        verts.shape[0],
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        faces.shape[0],
        height,
        width,
        float(focal),
        float(center[0]),
        float(center[1]),
        color.ctypes.data_as(dp),
        light.ctypes.data_as(dp),
        float(ambient),
        img.ctypes.data_as(dp),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return img, mask.astype(bool)


def get_dataloader() -> Optional[ctypes.CDLL]:
    """The batch-decoder library (libjpeg + libpng), built on first use;
    None when it cannot be built."""
    lib = _load("dataloader")
    if lib is None:
        return None
    if not getattr(lib, "_hpe_configured", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.hpe_decode_fit_batch.restype = ctypes.c_int
        lib.hpe_decode_fit_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # jpeg_ptrs
            ctypes.POINTER(ctypes.c_int64),  # jpeg_sizes
            ctypes.POINTER(ctypes.c_void_p),  # png_ptrs
            ctypes.POINTER(ctypes.c_int64),  # png_sizes
            ctypes.c_int64,  # n
            ctypes.c_int,  # canvas
            ctypes.POINTER(ctypes.c_int32),  # centers (or NULL)
            ctypes.c_int,  # window_half
            u8p,  # out_img
            u8p,  # out_seg
            ctypes.POINTER(ctypes.c_int32),  # out_hw (n, 6)
            ctypes.POINTER(ctypes.c_float),  # out_scale
            ctypes.POINTER(ctypes.c_int32),  # out_err
            ctypes.c_int,  # num_threads
        ]
        lib._hpe_configured = True
    return lib


def decode_fit_batch(
    jpeg_bytes: Sequence[bytes],
    png_bytes: Optional[Sequence[bytes]],
    canvas: int,
    num_threads: int = 0,
    centers: Optional[np.ndarray] = None,
    window_half: int = 0,
):
    """Decode a batch of JPEGs (and optional segmentation PNGs) into fixed
    uint8 canvases with the multithreaded native decoder.

    ``centers`` (N, 2) int32 (x, y) with ``window_half`` > 0 crop a person
    window at source resolution before the canvas fit; each example's
    window offset comes back for moving its labels.

    Returns (img (N, C, C, 3) u8, seg (N, C, C, 1) u8, hw (N, 2) i32 new
    dims, win_hw (N, 2) i32 window dims before the fit, off_yx (N, 2) i32
    window offsets, scale (N, 2) f32 = (fy, fx), err (N,) i32), or None
    when the library is unavailable. ``err[i] != 0`` marks a failed
    example (its outputs are zeroed). The geometry is
    ``data/npz_dataset._fit_to_canvas_np``'s; rescale labels with the
    float64 ratios hw / win_hw, not the float32 ``scale``.
    """
    lib = get_dataloader()
    if lib is None:
        return None
    n = len(jpeg_bytes)
    jb = [np.frombuffer(b, np.uint8) for b in jpeg_bytes]
    jpeg_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in jb])
    jpeg_sizes = (ctypes.c_int64 * n)(*[a.size for a in jb])
    if png_bytes is not None:
        pb = [np.frombuffer(b, np.uint8) if b else np.zeros(0, np.uint8) for b in png_bytes]
    else:
        pb = [np.zeros(0, np.uint8)] * n
    png_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data if a.size else None for a in pb])
    png_sizes = (ctypes.c_int64 * n)(*[a.size for a in pb])

    i32p = ctypes.POINTER(ctypes.c_int32)
    if centers is not None and window_half > 0:
        centers_arr = np.ascontiguousarray(centers, np.int32)
        if centers_arr.shape != (n, 2):
            raise ValueError(f"centers must be ({n}, 2), got {centers_arr.shape}")
        centers_ptr = centers_arr.ctypes.data_as(i32p)
    else:
        centers_ptr = None

    img = np.zeros((n, canvas, canvas, 3), np.uint8)
    seg = np.zeros((n, canvas, canvas, 1), np.uint8)
    hw = np.zeros((n, 6), np.int32)
    scale = np.zeros((n, 2), np.float32)
    err = np.zeros(n, np.int32)
    lib.hpe_decode_fit_batch(
        jpeg_ptrs,
        jpeg_sizes,
        png_ptrs,
        png_sizes,
        n,
        canvas,
        centers_ptr,
        int(window_half),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hw.ctypes.data_as(i32p),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        err.ctypes.data_as(i32p),
        int(num_threads),
    )
    return img, seg, hw[:, :2].copy(), hw[:, 2:4].copy(), hw[:, 4:6].copy(), scale, err
