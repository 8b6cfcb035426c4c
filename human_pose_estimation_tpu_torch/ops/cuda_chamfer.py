"""Bidirectional silhouette chamfer, value-only forward: a hand-written
CUDA kernel for Hopper (``csrc/chamfer_fwd.cu``), its plain PyTorch
version, and the wrapper that picks between them by device.

Counterpart of ``human_pose_estimation_tpu/ops/pallas_chamfer.py``'s
forward kernel (``_kernel`` / ``_chamfer_forward``, the primal of
``chamfer_pallas``). Per image, over the exact (P, V) squared-distance
field ``d = (g - p)^2``:

* gt->pred: the masked sum over pixels of ``|dx| + |dy|`` to the FIRST
  L2-nearest vertex (exact ties: the lowest vertex index wins, the
  reference's ``tf.argmin``);
* pred->gt: per vertex, the min of ``d`` over the pixels with mask > 0,
  then ``sum(sqrt(vmin))`` over the vertices that found a pixel;

and the image's value is 0 when its mask is empty.

The kernel is the forward only. A CUDA tensor that requires a gradient is
refused: the differentiable path (the fused value-and-gradient kernel
behind a ``torch.autograd.Function``) belongs to the training slice.

The library is built with ``nvcc`` at first use from the source in the
package, into ``build/kernels/`` at the root of the checkout, and loaded
with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "BIG",
    "LAUNCHES",
    "build",
    "chamfer_forward",
    "chamfer_forward_reference",
    "last_active",
]

BIG = 1e30  # "no pixel" sentinel of the pred->gt min, as in the JAX kernel

# Number of times the wrapper launched the CUDA kernel (one per call on
# CUDA tensors). chip_smoke.py sets it to 0 before the main path and reads
# it after, to show that the path went through the kernel.
LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "chamfer_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_lib = None
BUILD_SECONDS = None  # wall time of the nvcc call that built the library
BUILD_LOG = ""  # nvcc's output (ptxas registers / shared memory / spills)
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit puts it
_MAX_GRID_Y = 65535  # images ride on gridDim.y, which CUDA caps here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_NVCC_DEFAULT):
        return _NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA chamfer kernel cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libchamfer_fwd_{tag}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {_SOURCE.name}:\n{BUILD_LOG}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(out))
    lib.chamfer_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ] * 3
    lib.chamfer_fwd.restype = ctypes.c_int
    lib.chamfer_fwd_num_pixel_blocks.argtypes = [ctypes.c_int]
    lib.chamfer_fwd_num_pixel_blocks.restype = ctypes.c_int
    _lib = lib
    return lib


def last_active(gt_mask: torch.Tensor) -> torch.Tensor:
    """(N,) int32 index one past the last pixel with mask > 0 (0 when the
    mask is empty). Correct for any mask; for the production prefix masks
    it is the pixel count (``_last_active`` in the JAX kernel)."""
    p = gt_mask.shape[1]
    pos = torch.arange(1, p + 1, device=gt_mask.device, dtype=torch.int32)
    return torch.where(gt_mask > 0, pos, 0).amax(dim=1).to(torch.int32)


def _check(gt, mask, pred):
    if gt.dim() != 3 or gt.shape[-1] != 2:
        raise ValueError(f"gt_points must be (N, P, 2), got {tuple(gt.shape)}")
    if mask.shape != gt.shape[:2]:
        raise ValueError(f"gt_mask must be (N, P) = {tuple(gt.shape[:2])}, got {tuple(mask.shape)}")
    if pred.dim() != 3 or pred.shape[-1] != 2 or pred.shape[0] != gt.shape[0]:
        raise ValueError(f"pred_points must be (N, V, 2), got {tuple(pred.shape)}")
    if not (gt.device == mask.device == pred.device):
        raise ValueError("gt_points, gt_mask and pred_points must share a device")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); other devices are refused."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"unsupported device {t.device}")


def _epilogue(l1: torch.Tensor, vmin: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    has_gt = gt_mask.sum(dim=-1) > 0
    l2 = (torch.sqrt(vmin.clamp_min(0.0)) * (vmin < BIG / 2)).sum(dim=-1)
    return torch.where(has_gt, l1 + l2, torch.zeros_like(l1))


def chamfer_forward_reference(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    chunk: int = 1024,
) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances, in plain torch.

    The kernel's arithmetic, chunked over pixels so that the field fits on
    the card at the production shape (the whole (8, 16384, 6890) f32 field
    would be 3.6 GB per tensor): the direct form ``dx*dx + dy*dy`` (not the
    expanded form of the JAX ``chamfer_loss``), first-index ties, the same
    1e30 sentinel and the same empty-mask guard. Compute is f32 for any
    input dtype.
    """
    _check(gt_points, gt_mask, pred_points)
    gt = gt_points.float()
    mask = gt_mask.float()
    pred = pred_points.float()
    n, p, _ = gt.shape
    v = pred.shape[1]
    px = pred[:, None, :, 0]
    py = pred[:, None, :, 1]
    l1 = torch.zeros(n, device=gt.device)
    vmin = torch.full((n, v), BIG, device=gt.device)
    for s in range(0, p, chunk):
        g = gt[:, s : s + chunk]
        m = mask[:, s : s + chunk]
        dx = g[:, :, None, 0] - px  # (N, C, V)
        dy = g[:, :, None, 1] - py
        d = dx * dx + dy * dy
        # gt -> pred: argmin returns the first minimal index
        near = d.argmin(dim=2, keepdim=True)
        l1_near = (dx.abs() + dy.abs()).gather(2, near)[..., 0]
        l1 = l1 + (l1_near * m).sum(dim=1)
        # pred -> gt: running min over masked pixels
        d_masked = torch.where(m[:, :, None] > 0, d, torch.full_like(d, BIG))
        vmin = torch.minimum(vmin, d_masked.amin(dim=1))
    return _epilogue(l1, vmin, mask)


def chamfer_forward(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (there is no fallback: a failed build or launch raises). Inputs of any
    float dtype are cast to f32.
    """
    global LAUNCHES
    _check(gt_points, gt_mask, pred_points)
    if not _on_cuda(gt_points):
        return chamfer_forward_reference(gt_points, gt_mask, pred_points)
    if pred_points.requires_grad:
        raise NotImplementedError(
            "the CUDA chamfer kernel is forward-only; its gradient kernel "
            "comes with the training slice"
        )
    if gt_points.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_Y} images per call")
    lib = build()
    gt = gt_points.detach().float().contiguous()
    mask = gt_mask.detach().float().contiguous()
    pred = pred_points.detach().float().contiguous()
    n, p, _ = gt.shape
    v = pred.shape[1]
    counts = last_active(mask).contiguous()
    partial = torch.empty((n, lib.chamfer_fwd_num_pixel_blocks(p)), device=gt.device)
    vmin = torch.empty((n, v), device=gt.device)
    with torch.cuda.device(gt.device):
        stream = torch.cuda.current_stream(gt.device).cuda_stream
        err = lib.chamfer_fwd(
            gt.data_ptr(), mask.data_ptr(), pred.data_ptr(), counts.data_ptr(),
            n, p, v, partial.data_ptr(), vmin.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"chamfer_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    return _epilogue(partial.sum(dim=1), vmin, mask)
