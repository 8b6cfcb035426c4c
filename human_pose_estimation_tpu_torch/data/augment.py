"""Batched image augmentation and silhouette extraction on the device
(counterpart of ``human_pose_estimation_tpu/data/augment.py``).

The reference's per-example chain (scale-jittered resize, edge pad, crop,
maybe a horizontal flip) is ONE separable bilinear resampling per image:
two dense products per axis, ``W_y @ img @ W_x^T``, whose weight matrices
fold in the scale, the crop offset, the edge replication (coordinate
clamping) and the flip. The products run in f32.

The integer geometry is the JAX package's, operation for operation, so
that both packages pick the same source pixels:

* the resized size is ``floor(h * s)`` in f32 and the keypoint factor
  ``floor(h * s) / h``;
* the jittered, scaled centre truncates toward zero (``.to(int32)``, not
  ``floor``: a jittered centre can be negative);
* the crop starts at ``scaled_center - out // 2``; the resized integer
  coordinate is clamped to ``[0, floor(h * s) - 1]`` (the edge pad);
* the source coordinate has half-pixel centres, ``(r + 0.5) / factor -
  0.5``, clamped to ``[0, h - 1]``;
* a flip maps x to ``out - 1 - x`` and swaps the left and right joints
  of the 19-joint cocoplus order.

Random draws come from the caller's ``torch.Generator`` on the images'
device: translations uniform integers in ``[-trans_max, trans_max)``,
scales uniform in ``[scale_min, scale_max)``, flips ``rand < 0.5``.

``augment_slots`` is the same chain on whole images with K person slots
(Multi-HMR's input, the port's own): the crop is centred on the image's
centre, jittered, and every person's keypoints, centre and silhouette
move with it; the silhouettes come as one uint8 bit mask per canvas (bit
k is slot k's person, so that overlapping people keep their whole
silhouettes), resampled as K channels.
"""
from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from ..parallel import mesh as pmesh

__all__ = ["FLIP_SWAP_19", "AugmentConfig", "augment_batch", "augment_slots", "extract_silhouette"]

# L/R joint swap for horizontal flips, cocoplus 19-keypoint order
FLIP_SWAP_19 = (5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 16, 15, 18, 17)


@functools.lru_cache(maxsize=None)
def _flip_swap(device: torch.device) -> torch.Tensor:
    """FLIP_SWAP_19 on ``device``, copied there once: a copy from host
    memory in every call would make the host wait for the device."""
    return torch.as_tensor(FLIP_SWAP_19, device=device)


class AugmentConfig(NamedTuple):
    out_size: int = 224
    trans_max: int = 20
    scale_min: float = 0.8
    scale_max: float = 1.23
    augment: bool = True  # False -> deterministic center crop at scale 1


def _axis_weights(
    in_size: torch.Tensor,  # (N,) int32 true extent within the canvas
    canvas: int,
    out_size: int,
    scale: torch.Tensor,  # (N,) f32
    start: torch.Tensor,  # (N,) int32 crop start in resized coordinates
    flip: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """(N, out_size, canvas) bilinear sampling matrices for one axis."""
    dev = in_size.device
    f_in = in_size.float()
    new_size = torch.floor(f_in * scale)  # an int cast in the reference
    factor = new_size / f_in
    o = torch.arange(out_size, device=dev, dtype=torch.int32)
    o = torch.where(flip[:, None], out_size - 1 - o, o)
    # the integer coordinate in the resized image, edge-clamped (the edge pad)
    hi = (new_size.to(torch.int32) - 1).clamp_min(0)
    r = torch.minimum((start[:, None] + o).clamp_min(0), hi[:, None])
    # half-pixel-centre source coordinate, clamped to the valid extent
    s = (r.float() + 0.5) / factor[:, None] - 0.5
    s = torch.minimum(s.clamp_min(0.0), (f_in - 1.0)[:, None])
    i0 = torch.floor(s).to(torch.int32)
    i1 = torch.minimum(i0 + 1, (in_size - 1)[:, None])
    frac = s - i0.float()
    cols = torch.arange(canvas, device=dev, dtype=torch.int32)
    zero = torch.zeros((), device=dev)
    w = torch.where(cols == i0[..., None], (1.0 - frac)[..., None], zero)
    # at the edge i0 == i1: both terms hit one column and sum to 1
    return w + torch.where(cols == i1[..., None], frac[..., None], zero)


def _resample(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(N, H_out, W_out, C) = wy @ img @ wx^T per image, in f32, row-major
    as the JAX arrays are (einsum leaves H and W swapped in memory, and the
    encoder would then run in another memory format than on a plain batch)."""
    tmp = torch.einsum("noh,nhwc->nowc", wy, img)
    return torch.einsum("npw,nowc->nopc", wx, tmp).contiguous()


def _draws(n: int, cfg: AugmentConfig, generator: Optional[torch.Generator], dev: torch.device,
           global_draws: bool = False):
    """(trans (N, 2) int32, scales (N,) f32, flips (N,) bool). With
    ``global_draws`` under a process group, each draw is made for the
    global batch and this rank keeps its rows (``parallel.mesh.draw_rows``)."""
    if not cfg.augment:
        return (
            torch.zeros((n, 2), dtype=torch.int32, device=dev),
            torch.ones(n, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
        )
    if generator is None:
        raise ValueError("augment_batch draws from a torch.Generator; pass one (or overrides)")
    rows = pmesh.draw_rows if global_draws else (lambda draw, shape: draw(shape))
    if cfg.trans_max > 0:
        trans = rows(
            lambda shape: torch.randint(
                -cfg.trans_max, cfg.trans_max, shape, generator=generator, device=dev, dtype=torch.int32
            ),
            (n, 2),
        )
    else:
        trans = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    u = rows(lambda shape: torch.rand(shape, generator=generator, device=dev), (n,))
    scales = cfg.scale_min + (cfg.scale_max - cfg.scale_min) * u
    flips = rows(lambda shape: torch.rand(shape, generator=generator, device=dev), (n,)) < 0.5
    return trans, scales, flips


def augment_batch(
    images: torch.Tensor,  # (N, Hc, Wc, 3) uint8, or float in [0, 1]
    segs: torch.Tensor,  # (N, Hc, Wc, 1) same scale
    hw: torch.Tensor,  # (N, 2) int true [h, w] inside the canvas
    centers: torch.Tensor,  # (N, 2) int [cx, cy] person centre
    keypoints: torch.Tensor,  # (N, 3, 19) rows [x, y, vis]
    generator: Optional[torch.Generator],
    cfg: AugmentConfig,
    overrides: Optional[Tuple] = None,
    global_draws: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched preprocess on the images' device: (crop in [-1, 1]
    (N, S, S, 3), seg crop (N, S, S, 1), labels (N, 19, 3) with the
    keypoints normalised to [-1, 1] and hidden ones zeroed).

    ``overrides=(trans (N, 2) int, scales (N,), flips (N,) bool)`` pins the
    draws; otherwise ``cfg.augment`` draws them from ``generator`` (a
    ``torch.Generator`` on the images' device) and ``augment=False`` is the
    centre crop at scale 1. ``global_draws``: under a process group, draw
    for the global batch and keep this rank's rows (the fused training
    step); a pipeline's own preprocessing draws per rank."""
    n = images.shape[0]
    dev = images.device
    trans, scales, flips = _pinned_or_drawn(n, cfg, generator, dev, overrides, global_draws)
    crops, crop_segs, geometry = _crop(images, segs, hw, centers, trans, scales, flips, cfg.out_size)
    return crops, crop_segs, _move_keypoints(keypoints, dev, *geometry, flips, cfg.out_size)


def _pinned_or_drawn(n, cfg, generator, dev, overrides, global_draws):
    """(trans, scales, flips): ``overrides`` on ``dev``, or ``_draws``'."""
    if overrides is not None:
        trans, scales, flips = (torch.as_tensor(t, device=dev) for t in overrides)
        return trans.to(torch.int32), scales.float(), flips.bool()
    return _draws(n, cfg, generator, dev, global_draws)


def _crop(images, segs, hw, centers, trans, scales, flips, out: int):
    """(crops in [-1, 1], seg crops, the geometry (fx, fy, start_x,
    start_y)) of ``augment_batch``."""
    _, canvas_h, canvas_w, _ = images.shape
    dev = images.device
    margin = out // 2
    images = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
    segs = segs.float() / 255.0 if segs.dtype == torch.uint8 else segs.float()

    hw = hw.to(device=dev, dtype=torch.int32)
    center_j = centers.to(device=dev, dtype=torch.int32) + trans  # jittered centre
    h, w = hw[:, 0], hw[:, 1]
    fx = torch.floor(w.float() * scales) / w.float()
    fy = torch.floor(h.float() * scales) / h.float()
    # int(center * floor(extent * s) / extent): truncation toward zero
    start_x = (center_j[:, 0].float() * fx).to(torch.int32) - margin
    start_y = (center_j[:, 1].float() * fy).to(torch.int32) - margin

    no_flip = torch.zeros_like(flips)
    wy = _axis_weights(h, canvas_h, out, scales, start_y, no_flip)
    wx = _axis_weights(w, canvas_w, out, scales, start_x, flips)
    crops = _resample(images, wy, wx)
    crop_segs = _resample(segs, wy, wx)
    return crops * 2.0 - 1.0, crop_segs, (fx, fy, start_x, start_y)


def _move_keypoints(keypoints, dev, fx, fy, start_x, start_y, flips, out: int) -> torch.Tensor:
    """(N, ..., 3, 19) keypoint rows [x, y, vis] in canvas pixels -> (N,
    ..., 19, 3) labels: the crop's geometry, a flip's swap of the left and
    right joints, normalised to [-1, 1] with hidden ones zeroed."""
    keypoints = keypoints.to(device=dev, dtype=torch.float32)
    per_row = (-1,) + (1,) * (keypoints.dim() - 2)  # an image's scalars over its keypoint rows
    vis = keypoints[..., 2, :]
    x = keypoints[..., 0, :] * fx.view(per_row) - start_x.view(per_row).float()
    y = keypoints[..., 1, :] * fy.view(per_row) - start_y.view(per_row).float()
    swap = _flip_swap(dev)
    x_f = float(out) - x - 1.0
    f = flips.view(per_row)
    x = torch.where(f, x_f[..., swap], x)
    y = torch.where(f, y[..., swap], y)
    vis = torch.where(f, vis[..., swap], vis)

    # normalise to [-1, 1], zeroing hidden keypoints
    vis = (vis > 0).float()
    return torch.stack([(2.0 * (x / out) - 1.0) * vis, (2.0 * (y / out) - 1.0) * vis, vis], dim=-1)


def augment_slots(
    images: torch.Tensor,  # (B, S, S, 3) uint8 whole images
    segs: torch.Tensor,  # (B, S, S) uint8, bit k: slot k's silhouette
    centers: torch.Tensor,  # (B, K, 2) int [cx, cy] each person's centre
    keypoints: torch.Tensor,  # (B, K, 3, 19) rows [x, y, vis]
    present: torch.Tensor,  # (B, K) a person fills the slot
    generator: Optional[torch.Generator],
    cfg: AugmentConfig,
    overrides: Optional[Tuple] = None,
    global_draws: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``augment_batch`` on whole images with K person slots, on the
    images' device: the crop of ``cfg.out_size`` around the image's centre,
    jittered and scaled by the draws (``overrides`` pins them). Returns
    (crops (B, S', S', 3) in [-1, 1], silhouette crops (B, S', S', K),
    labels (B, K, 19, 3), centres (B, K, 2) f32 in crop pixels, valid (B, K)
    f32: a person fills the slot and its centre lies inside the crop)."""
    b, canvas_h, canvas_w, _ = images.shape
    dev = images.device
    k, out = keypoints.shape[1], cfg.out_size
    silhouettes = ((segs.to(dev)[..., None] >> torch.arange(k, device=dev, dtype=torch.uint8)) & 1).float()
    # filled on the device: a host value copied there would make the host wait
    full = lambda *v: torch.cat([torch.full((b, 1), x, dtype=torch.int32, device=dev) for x in v], 1)  # noqa: E731
    hw, middle = full(canvas_h, canvas_w), full(canvas_w // 2, canvas_h // 2)
    trans, scales, flips = _pinned_or_drawn(b, cfg, generator, dev, overrides, global_draws)
    crops, crop_segs, geometry = _crop(images, silhouettes, hw, middle, trans, scales, flips, out)
    fx, fy, start_x, start_y = geometry
    label = _move_keypoints(keypoints, dev, *geometry, flips, out)
    c = centers.to(device=dev, dtype=torch.float32)
    cx = c[..., 0] * fx[:, None] - start_x[:, None].float()
    cx = torch.where(flips[:, None], float(out) - cx - 1.0, cx)
    cy = c[..., 1] * fy[:, None] - start_y[:, None].float()
    valid = (present.to(dev) > 0) & (cx >= 0) & (cx < out) & (cy >= 0) & (cy < out)
    label = label * valid[..., None, None]
    return crops, crop_segs, label, torch.stack([cx, cy], dim=-1), valid.float()


# prime strides of the fallback visit order, largest first
_STRIDES = (8191, 4093, 2039, 1021, 509, 251, 127, 61, 31, 13, 7, 5, 3, 1)


def extract_silhouette(
    segs: torch.Tensor, max_points: int, threshold: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size silhouette pixel lists from seg crops (N, H, W, 1):
    ((N, min(P, H*W), 2) [x, y] f32, (N, min(P, H*W)) f32 prefix mask).

    Pixels are visited in an interleaved order, so that truncation at
    ``max_points`` samples the whole figure, in the JAX package's order
    exactly: the first ``max_points`` entries are the same pixels in the
    same order.

    * ``H*W <= 2^16``: pixel f's key is ``(f * 40503) & 0xFFFF``, packed
      with f as ``(key << 16) | f`` and sorted, inactive pixels at
      ``0xFFFFFFFF``. The pack is int64 (an exact stand-in for JAX's
      uint32; the low 16 bits of the product equal its wrapped int32).
    * Larger crops: key ``(f * stride) % (H*W)`` with the largest prime
      stride coprime with ``H*W``; real keys are unique, so the valid
      prefix has one order.
    """
    n, h, w = segs.shape[:3]
    total = h * w
    m = segs.reshape(n, total) > threshold
    iota = torch.arange(total, device=segs.device, dtype=torch.int64).expand(n, total)
    if total <= 1 << 16:
        key = (iota * 40503) & 0xFFFF
        pack = torch.where(m, (key << 16) | iota, torch.full_like(iota, 0xFFFFFFFF))
        sorted_f = torch.sort(pack, dim=1).values[:, :max_points] & 0xFFFF
    else:
        stride = next(s for s in _STRIDES if total % s and (total - 1) * s < 2**31)
        if stride == 1:  # only for ~2^30-pixel crops
            warnings.warn(
                f"extract_silhouette: {h}x{w} seg too large for an interleaved truncation "
                "stride; falling back to row order (truncation will bias toward top rows)",
                stacklevel=2,
            )
        keys = torch.where(m, (iota * stride) % total, torch.full_like(iota, 2**31 - 1))
        sorted_f = torch.sort(keys, dim=1).indices[:, :max_points]
    counts = m.sum(dim=1)
    valid = iota[:, :max_points] < counts[:, None]
    flat = torch.where(valid, sorted_f, 0)  # 0-padded
    pts = torch.stack([flat % w, flat // w], dim=-1).float()
    return pts, valid.float()
