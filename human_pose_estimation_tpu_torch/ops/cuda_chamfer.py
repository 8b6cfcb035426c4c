"""Bidirectional silhouette chamfer: hand-written CUDA kernels for Hopper,
their plain PyTorch versions, the wrappers that pick between them by
device, and the ``torch.autograd.Function`` that makes the loss
differentiable.

Counterpart of ``human_pose_estimation_tpu/ops/pallas_chamfer.py``. Per
image, over the exact (P, V) squared-distance field ``d = (g - p)^2``:

* gt->pred: the masked sum over pixels of ``|dx| + |dy|`` to the FIRST
  L2-nearest vertex (exact ties: the lowest vertex index wins, the
  reference's ``tf.argmin``);
* pred->gt: per vertex, the min of ``d`` over the pixels with mask > 0,
  then ``sum(sqrt(vmin))`` over the vertices that found a pixel;

and the image's value is 0 when its mask is empty.

Kernels (``csrc/``):

* K1 ``chamfer_fwd.cu`` (``chamfer_forward``; ``chamfer_forward_parts``
  for the L1 and ``vmin`` before the epilogue): the value only, the
  forward kernel ``_kernel`` / ``_chamfer_forward``, in one call of six
  launches (the last active pixels, two passes split into chunks and each
  merged in chunk order, the epilogue). Evaluation runs it.
* K2 ``chamfer_bwd.cu`` (``chamfer_value_and_grad``): value and the
  gradient with respect to ``pred`` in one call of four launches (two
  passes split into chunks, each merged in chunk order), ``_bwd_kernel``
  with ``l1v_ref`` (``_chamfer_value_and_grad_pallas``). The training step
  runs it through ``ChamferFunction``.
* K3, the same launch without the value (``chamfer_grad``,
  ``_chamfer_grad_pred_pallas``), scaled by a cotangent.
* K4, K2 with its index carriers in f32 (``f32_index=True``), the design
  probe ``_bwd_kernel_f32idx`` of ``benchmarks/chamfer_variant_bench.py``.

The gradient follows the JAX package's analytic VJP (``_chamfer_grad_pred``):
``-mask * sign(g - p)`` added onto each pixel's nearest vertex, plus the
unit vector from each vertex's first nearest pixel (1e-12 guard, zero
where no pixel was found), all times ``has_gt``.

The libraries are built with ``nvcc`` at first use from the sources in the
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
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.tracing import span

__all__ = [
    "BIG",
    "F32IDX_LAUNCHES",
    "GRAD_LAUNCHES",
    "LAUNCHES",
    "VALUE_GRAD_LAUNCHES",
    "BwdParts",
    "ChamferFunction",
    "build",
    "build_all",
    "build_bwd",
    "bwd_resident_warps",
    "bwd_tiling",
    "chamfer",
    "chamfer_bwd_parts",
    "chamfer_bwd_parts_reference",
    "chamfer_forward",
    "chamfer_forward_parts",
    "chamfer_forward_parts_reference",
    "chamfer_forward_reference",
    "chamfer_grad",
    "chamfer_grad_reference",
    "chamfer_value_and_grad",
    "chamfer_value_and_grad_reference",
    "fwd_resident_warps",
    "fwd_tiling",
    "last_active",
]

BIG = 1e30  # "no pixel" sentinel of the pred->gt min, as in the JAX kernel

# Number of times each wrapper launched its CUDA kernel (one per call on
# CUDA tensors): K1, K2, K3 and K4. chip_smoke.py sets them to 0 before
# the main path and reads them after, to show that the path went through
# the kernels.
LAUNCHES = 0
VALUE_GRAD_LAUNCHES = 0
GRAD_LAUNCHES = 0
F32IDX_LAUNCHES = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {"chamfer_fwd": _CSRC / "chamfer_fwd.cu", "chamfer_bwd": _CSRC / "chamfer_bwd.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_lib = None  # the loaded chamfer_fwd library
_lib_bwd = None  # the loaded chamfer_bwd library
BUILD_SECONDS = {}  # source name -> wall time of the nvcc call that built it
BUILD_LOG = {}  # source name -> nvcc's output (ptxas registers / shared memory / spills)
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit puts it
_MAX_GRID_Y = 65535  # images ride on gridDim.y or gridDim.z, which CUDA caps here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_NVCC_DEFAULT):
        return _NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA chamfer kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = _SOURCES[name].read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"lib{name}_{tag}.so"


def _compile(names) -> None:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together; raise if any fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the K1 library."""
    global _lib
    if _lib is None:
        _compile(["chamfer_fwd"])
        _lib = _load_fwd(_lib_path("chamfer_fwd"))
    return _lib


def _load_fwd(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/chamfer_fwd.cu`` and declare its C
    interface."""
    lib = ctypes.CDLL(str(path))
    lib.chamfer_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    lib.chamfer_fwd.restype = ctypes.c_int
    lib.chamfer_fwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.chamfer_fwd_scratch_bytes.restype = ctypes.c_longlong
    lib.chamfer_fwd_tiling.argtypes = [ctypes.c_void_p]
    lib.chamfer_fwd_tiling.restype = None
    lib.chamfer_fwd_resident_warps.argtypes = [ctypes.c_void_p]
    lib.chamfer_fwd_resident_warps.restype = ctypes.c_int
    return lib


def fwd_tiling(lib: Optional[ctypes.CDLL] = None) -> dict:
    """The compiled sizes of a K1 library (the default build if None):
    pixel chunk and vertex chunk of its two split passes, pixels and
    vertices held per thread, and the group in which the pixel pass keeps
    the first index of its min."""
    out = (ctypes.c_int * 5)()
    (lib or build()).chamfer_fwd_tiling(out)
    return dict(zip(("pixel_chunk", "vertex_chunk", "pixels_per_thread", "verts_per_thread", "group"), out))


def fwd_resident_warps(lib: Optional[ctypes.CDLL] = None) -> dict:
    """Resident warps per SM of K1's kernels, from the CUDA occupancy
    calculator on the current device."""
    out = (ctypes.c_int * 6)()
    err = (lib or build()).chamfer_fwd_resident_warps(out)
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: cudaError {err}")
    return dict(zip(("count", "pixel_pass", "pixel_merge", "vertex_pass", "vertex_merge", "finish"), out))


def build_bwd() -> ctypes.CDLL:
    """Compile (once per source version) and load the K2/K3/K4 library."""
    global _lib_bwd
    if _lib_bwd is None:
        _compile(["chamfer_bwd"])
        _lib_bwd = _load_bwd(_lib_path("chamfer_bwd"))
    return _lib_bwd


def _load_bwd(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/chamfer_bwd.cu`` and declare its C
    interface."""
    lib = ctypes.CDLL(str(path))
    lib.chamfer_bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    )
    lib.chamfer_bwd.restype = ctypes.c_int
    lib.chamfer_bwd_num_pixel_blocks.argtypes = [ctypes.c_int]
    lib.chamfer_bwd_num_pixel_blocks.restype = ctypes.c_int
    lib.chamfer_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.chamfer_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.chamfer_bwd_tiling.argtypes = [ctypes.c_void_p]
    lib.chamfer_bwd_tiling.restype = None
    lib.chamfer_bwd_resident_warps.argtypes = [ctypes.c_void_p]
    lib.chamfer_bwd_resident_warps.restype = ctypes.c_int
    return lib


def bwd_tiling(lib: Optional[ctypes.CDLL] = None) -> dict:
    """The compiled sizes of a K2 library (the default build if None):
    pixel chunk and vertex chunk of its two split passes, pixels and
    vertices held per thread, and the group in which each chunk keeps the
    first index of its min."""
    out = (ctypes.c_int * 5)()
    (lib or build_bwd()).chamfer_bwd_tiling(out)
    return dict(zip(("pixel_chunk", "vertex_chunk", "pixels_per_thread", "verts_per_thread", "group"), out))


def bwd_resident_warps(lib: Optional[ctypes.CDLL] = None) -> dict:
    """Resident warps per SM of K2's four kernels, from the CUDA occupancy
    calculator on the current device."""
    out = (ctypes.c_int * 4)()
    err = (lib or build_bwd()).chamfer_bwd_resident_warps(out)
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: cudaError {err}")
    return dict(zip(("assign", "assign_merge", "vertex", "vertex_merge"), out))


def build_all() -> None:
    """Build every kernel library in parallel, then load them."""
    _compile(list(_SOURCES))
    build()
    build_bwd()


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


def chamfer_forward_parts_reference(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1's two directions before the epilogue: the
    (N,) masked gt->pred L1 sum and the (N, V) pred->gt ``vmin``.

    The kernel's arithmetic, chunked over pixels so that the field fits on
    the card at the production shape (the whole (8, 16384, 6890) f32 field
    would be 3.6 GB per tensor): the direct form ``dx*dx + dy*dy`` (not the
    expanded form of the JAX ``chamfer_loss``), first-index ties and the
    same 1e30 sentinel. Compute is f32 for any input dtype.
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
    return l1, vmin


def chamfer_forward_reference(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    chunk: int = 1024,
) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances, in plain torch:
    ``chamfer_forward_parts_reference`` and the empty-mask guard."""
    l1, vmin = chamfer_forward_parts_reference(gt_points, gt_mask, pred_points, chunk)
    return _epilogue(l1, vmin, gt_mask.float())


def _forward_cuda(gt_points, gt_mask, pred_points, parts: bool):
    """K1 on CUDA tensors, counted in ``LAUNCHES``: (value, L1, vmin), the
    last two only with ``parts``."""
    global LAUNCHES
    if pred_points.requires_grad:
        raise NotImplementedError(
            "chamfer_forward is the value-only kernel; take the gradient "
            "through chamfer() / ChamferFunction"
        )
    if gt_points.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_Y} images per call")
    out = _launch_fwd(build(), gt_points, gt_mask, pred_points, parts)
    LAUNCHES += 1
    return out


def chamfer_forward(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances (K1).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (there is no fallback: a failed build or launch raises). Inputs of any
    float dtype are cast to f32. The kernel is the value only: a CUDA
    ``pred`` that requires a gradient is refused (``chamfer`` is the
    differentiable entry).
    """
    with span("chamfer.k1"):
        _check(gt_points, gt_mask, pred_points)
        if not _on_cuda(gt_points):
            return chamfer_forward_reference(gt_points, gt_mask, pred_points)
        return _forward_cuda(gt_points, gt_mask, pred_points, parts=False)[0]


def chamfer_forward_parts(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's two directions before the epilogue: the (N,) masked gt->pred
    L1 sum and the (N, V) pred->gt ``vmin``, as
    ``chamfer_forward_parts_reference`` computes them. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(gt_points, gt_mask, pred_points)
    if not _on_cuda(gt_points):
        return chamfer_forward_parts_reference(gt_points, gt_mask, pred_points)
    _, l1, vmin = _forward_cuda(gt_points, gt_mask, pred_points, parts=True)
    return l1, vmin


def _launch_fwd(lib, gt_points, gt_mask, pred_points, parts: bool):
    """One call of the K1 library ``lib`` on CUDA tensors: (value, L1,
    vmin), the last two only with ``parts``. The library computes the
    last active pixels, both directions and the epilogue; the wrapper
    only allocates the scratch and the outputs with ``torch.empty`` at the
    sizes the library reports. The kernels run on the current stream, with
    no host synchronisation."""
    gt = gt_points.detach().float().contiguous()
    mask = gt_mask.detach().float().contiguous()
    pred = pred_points.detach().float().contiguous()
    n, p, _ = gt.shape
    v = pred.shape[1]
    dev = gt.device
    scratch = torch.empty(lib.chamfer_fwd_scratch_bytes(n, p, v), device=dev, dtype=torch.uint8)
    value = torch.empty(n, device=dev)
    l1 = torch.empty(n, device=dev) if parts else None
    vmin = torch.empty((n, v), device=dev) if parts else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamfer_fwd(
            gt.data_ptr(), mask.data_ptr(), pred.data_ptr(), n, p, v, scratch.data_ptr(), value.data_ptr(),
            l1.data_ptr() if parts else None, vmin.data_ptr() if parts else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"chamfer_fwd launch failed: cudaError {err}")
    return value, l1, vmin


class BwdParts(NamedTuple):
    """What the value-and-gradient pass computes before the epilogue."""

    l1_value: Optional[torch.Tensor]  # (N,) masked gt->pred L1 sum (None without the value)
    vmin: torch.Tensor  # (N, V) pred->gt min of d over masked pixels (BIG: none)
    l1_grad: torch.Tensor  # (N, V, 2) sum of -mask * sign(g - p) over assigned pixels
    l2_grad: torch.Tensor  # (N, V, 2) unit vector from the first nearest pixel


def chamfer_bwd_parts_reference(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    chunk: int = 1024,
) -> BwdParts:
    """The plain version of the K2/K3 pass (``_chamfer_grad_pred`` plus the
    value), chunked over pixels: the direct form of ``d``, first-index
    argmin in both directions, a strict ``<`` across chunks, the 1e30
    sentinel and the 1e-12 guard. Compute is f32 for any input dtype."""
    _check(gt_points, gt_mask, pred_points)
    gt = gt_points.detach().float()
    mask = gt_mask.detach().float()
    pred = pred_points.detach().float()
    n, p, _ = gt.shape
    v = pred.shape[1]
    dev = gt.device
    px = pred[:, None, :, 0]
    py = pred[:, None, :, 1]
    l1 = torch.zeros(n, device=dev)
    l1_grad = torch.zeros(n, v, 2, device=dev)
    vmin = torch.full((n, v), BIG, device=dev)
    best = torch.zeros(n, v, 2, device=dev)
    for s in range(0, p, chunk):
        g = gt[:, s : s + chunk]
        m = mask[:, s : s + chunk]
        dx = g[:, :, None, 0] - px  # (N, C, V)
        dy = g[:, :, None, 1] - py
        d = dx * dx + dy * dy
        # gt -> pred: each pixel's first nearest vertex
        near = d.argmin(dim=2, keepdim=True)  # (N, C, 1)
        ndx = dx.gather(2, near)[..., 0]
        ndy = dy.gather(2, near)[..., 0]
        l1 = l1 + (m * ndx.abs() + m * ndy.abs()).sum(dim=1)
        signs = torch.stack([m * torch.sign(ndx), m * torch.sign(ndy)], dim=-1)  # (N, C, 2)
        l1_grad.scatter_add_(1, near.expand(-1, -1, 2), -signs)
        # pred -> gt: the first masked pixel at the running min
        d_masked = torch.where(m[:, :, None] > 0, d, torch.full_like(d, BIG))
        row = d_masked.argmin(dim=1)  # (N, V)
        cmin = d_masked.gather(1, row[:, None, :])[:, 0]
        cxy = g.gather(1, row[..., None].expand(-1, -1, 2))  # (N, V, 2)
        take = cmin < vmin
        best = torch.where(take[..., None], cxy, best)
        vmin = torch.where(take, cmin, vmin)
    delta = pred - best
    norm = torch.sqrt((delta * delta).sum(dim=-1, keepdim=True))
    l2_grad = torch.where(norm > 1e-12, delta / norm.clamp_min(1e-12), torch.zeros_like(delta))
    l2_grad = torch.where((vmin < BIG / 2)[..., None], l2_grad, torch.zeros_like(l2_grad))
    return BwdParts(l1, vmin, l1_grad, l2_grad)


def chamfer_bwd_parts(
    gt_points: torch.Tensor,  # (N, P, 2)
    gt_mask: torch.Tensor,  # (N, P)
    pred_points: torch.Tensor,  # (N, V, 2)
    with_value: bool = True,
    f32_index: bool = False,
) -> BwdParts:
    """The K2 (``with_value``) / K3 pass; ``f32_index`` picks K4, the
    instance whose index carriers are f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel, and a failed build or launch
    raises."""
    global VALUE_GRAD_LAUNCHES, GRAD_LAUNCHES, F32IDX_LAUNCHES
    _check(gt_points, gt_mask, pred_points)
    if not _on_cuda(gt_points):
        parts = chamfer_bwd_parts_reference(gt_points, gt_mask, pred_points)
        return parts if with_value else parts._replace(l1_value=None)
    if gt_points.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_Y} images per call")
    parts = _launch_bwd(build_bwd(), gt_points, gt_mask, pred_points, with_value, f32_index)
    if f32_index:
        F32IDX_LAUNCHES += 1
    elif with_value:
        VALUE_GRAD_LAUNCHES += 1
    else:
        GRAD_LAUNCHES += 1
    return parts


def _launch_bwd(lib, gt_points, gt_mask, pred_points, with_value: bool, f32_index: bool) -> BwdParts:
    """One launch of the K2/K3/K4 library ``lib`` on CUDA tensors: scratch
    and outputs from ``torch.empty`` at the sizes the library reports, the
    four kernels on the current stream, no host synchronisation."""
    gt = gt_points.detach().float().contiguous()
    mask = gt_mask.detach().float().contiguous()
    pred = pred_points.detach().float().contiguous()
    n, p, _ = gt.shape
    v = pred.shape[1]
    dev = gt.device
    counts = last_active(mask).contiguous()
    scratch = torch.empty(lib.chamfer_bwd_scratch_bytes(n, p, v), device=dev, dtype=torch.uint8)
    partial = torch.empty((n, lib.chamfer_bwd_num_pixel_blocks(p) if with_value else 1), device=dev)
    vmin = torch.empty((n, v), device=dev)
    l1_grad = torch.empty((n, v, 2), device=dev)
    l2_grad = torch.empty((n, v, 2), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chamfer_bwd(
            gt.data_ptr(), mask.data_ptr(), pred.data_ptr(), counts.data_ptr(),
            n, p, v, int(with_value), int(f32_index), scratch.data_ptr(), partial.data_ptr(),
            vmin.data_ptr(), l1_grad.data_ptr(), l2_grad.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"chamfer_bwd launch failed: cudaError {err}")
    return BwdParts(partial.sum(dim=1) if with_value else None, vmin, l1_grad, l2_grad)


def _value_and_grad(parts: BwdParts, gt_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epilogue of ``_chamfer_value_and_grad_pallas``."""
    has_gt = (gt_mask.detach().float().sum(dim=-1) > 0).float()
    vmin = parts.vmin
    l2_value = (torch.sqrt(vmin.clamp_min(0.0)) * (vmin < BIG / 2)).sum(dim=-1)
    value = has_gt * (parts.l1_value + l2_value)
    return value, has_gt[:, None, None] * (parts.l1_grad + parts.l2_grad)


def _grad(parts: BwdParts, gt_mask: torch.Tensor, cotangent: torch.Tensor) -> torch.Tensor:
    """The epilogue of ``_chamfer_grad_pred_pallas``."""
    has_gt = (gt_mask.detach().float().sum(dim=-1) > 0).float()
    scale = (cotangent.detach().float() * has_gt)[:, None, None]
    return scale * (parts.l1_grad + parts.l2_grad)


def chamfer_value_and_grad_reference(gt_points, gt_mask, pred_points, chunk: int = 1024):
    """Plain version of K2: ((N,) value, (N, V, 2) unscaled d value / d pred)."""
    return _value_and_grad(chamfer_bwd_parts_reference(gt_points, gt_mask, pred_points, chunk), gt_mask)


def chamfer_grad_reference(gt_points, gt_mask, pred_points, cotangent, chunk: int = 1024):
    """Plain version of K3: (N, V, 2) cotangent-scaled d value / d pred."""
    parts = chamfer_bwd_parts_reference(gt_points, gt_mask, pred_points, chunk)
    return _grad(parts, gt_mask, cotangent)


def chamfer_value_and_grad(gt_points, gt_mask, pred_points, f32_index: bool = False):
    """K2 (K4 with ``f32_index``): ((N,) value, (N, V, 2) unscaled gradient)."""
    return _value_and_grad(chamfer_bwd_parts(gt_points, gt_mask, pred_points, True, f32_index), gt_mask)


def chamfer_grad(gt_points, gt_mask, pred_points, cotangent):
    """K3: the gradient only, scaled by the (N,) cotangent."""
    parts = chamfer_bwd_parts(gt_points, gt_mask, pred_points, with_value=False)
    return _grad(parts, gt_mask, cotangent)


class ChamferFunction(torch.autograd.Function):
    """The differentiable chamfer, counterpart of the custom VJP
    ``chamfer_pallas``: when ``pred`` needs a gradient the forward runs K2
    once and keeps the unscaled gradient, and the backward scales it by the
    cotangent; otherwise the forward runs K1. gt and mask get no gradient
    (JAX returns zeros for them)."""

    @staticmethod
    def forward(ctx, gt_points, gt_mask, pred_points):
        if ctx.needs_input_grad[2]:
            with span("chamfer.k2"):
                value, grad = chamfer_value_and_grad(gt_points, gt_mask, pred_points)
            ctx.save_for_backward(grad)
            ctx.pred_dtype = pred_points.dtype
            return value
        return chamfer_forward(gt_points, gt_mask, pred_points.detach())

    @staticmethod
    def backward(ctx, cotangent):
        (grad,) = ctx.saved_tensors
        return None, None, (cotangent[:, None, None] * grad).to(ctx.pred_dtype)


def chamfer(gt_points: torch.Tensor, gt_mask: torch.Tensor, pred_points: torch.Tensor) -> torch.Tensor:
    """(N,) unnormalized bidirectional chamfer distances, differentiable
    with respect to ``pred_points`` (``ChamferFunction``). Under
    ``torch.no_grad`` it is the value-only K1 path."""
    if not torch.is_grad_enabled():  # needs_input_grad does not see grad mode
        return chamfer_forward(gt_points, gt_mask, pred_points.detach())
    return ChamferFunction.apply(gt_points, gt_mask, pred_points)
