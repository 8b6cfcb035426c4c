"""The plain reference of the device-side input path: the scale-jittered,
translated and maybe flipped crop of each canvas as one separable bilinear
resampling (edge pixels replicated, half-pixel centres), the keypoints
moved with it, and the fixed-size silhouette pixel list in its interleaved
visit order.

The integer geometry is the reference implementation's: the resized
extent is floor(h * s); the jittered centre scaled and truncated toward
zero; the crop starts at that centre minus half the output; a flip maps x
to out - 1 - x and swaps the left and right joints. The draws, per batch
of N: translations uniform integers in [-trans_max, trans_max) (N, 2),
then scales uniform in [scale_min, scale_max) (N,), then flips rand < 0.5
(N,), from the step's generator.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

FLIP_SWAP_19 = (5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 16, 15, 18, 17)


class Prepared(NamedTuple):
    images: torch.Tensor  # (N, S, S, 3) in [-1, 1]
    seg_points: torch.Tensor  # (N, P, 2) [x, y]
    seg_mask: torch.Tensor  # (N, P)
    kp2d: torch.Tensor  # (N, 19, 3) [x, y, vis] in [-1, 1]


def _axis(in_size, canvas: int, out: int, scale, start, flip):
    dev = in_size.device
    f_in = in_size.float()
    new = torch.floor(f_in * scale)
    factor = new / f_in
    o = torch.arange(out, device=dev, dtype=torch.int32)
    o = torch.where(flip[:, None], out - 1 - o, o)
    hi = (new.to(torch.int32) - 1).clamp_min(0)
    r = torch.minimum((start[:, None] + o).clamp_min(0), hi[:, None])
    s = (r.float() + 0.5) / factor[:, None] - 0.5
    s = torch.minimum(s.clamp_min(0.0), (f_in - 1.0)[:, None])
    i0 = torch.floor(s).to(torch.int32)
    i1 = torch.minimum(i0 + 1, (in_size - 1)[:, None])
    frac = s - i0.float()
    cols = torch.arange(canvas, device=dev, dtype=torch.int32)
    zero = torch.zeros((), device=dev)
    w = torch.where(cols == i0[..., None], (1.0 - frac)[..., None], zero)
    return w + torch.where(cols == i1[..., None], frac[..., None], zero)


def _resample(img, wy, wx):
    return torch.einsum("npw,nowc->nopc", wx, torch.einsum("noh,nhwc->nowc", wy, img)).contiguous()


def draws(n: int, cfg: dict, generator, device):
    """(trans (N, 2) int32, scales (N,), flips (N,) bool) from ``generator``."""
    t = cfg["trans_max"]
    trans = torch.randint(-t, t, (n, 2), generator=generator, device=device, dtype=torch.int32)
    u = torch.rand((n,), generator=generator, device=device)
    scales = cfg["scale_min"] + (cfg["scale_max"] - cfg["scale_min"]) * u
    flips = torch.rand((n,), generator=generator, device=device) < 0.5
    return trans, scales, flips


def crop(image, seg, hw, center, label, out: int, trans, scales, flips):
    """(crops (N, out, out, 3) in [-1, 1], seg crops (N, out, out, 1), labels
    (N, 19, 3)) from uint8 canvases."""
    n, ch, cw, _ = image.shape
    dev = image.device
    image = image.float() / 255.0
    seg = seg.float() / 255.0
    hw = hw.to(device=dev, dtype=torch.int32)
    cj = center.to(device=dev, dtype=torch.int32) + trans
    h, w = hw[:, 0], hw[:, 1]
    fx = torch.floor(w.float() * scales) / w.float()
    fy = torch.floor(h.float() * scales) / h.float()
    sx = (cj[:, 0].float() * fx).to(torch.int32) - out // 2
    sy = (cj[:, 1].float() * fy).to(torch.int32) - out // 2
    wy = _axis(h, ch, out, scales, sy, torch.zeros_like(flips))
    wx = _axis(w, cw, out, scales, sx, flips)
    crops, segs = _resample(image, wy, wx), _resample(seg, wy, wx)
    kp = label.to(device=dev, dtype=torch.float32)
    vis = kp[:, 2]
    x = kp[:, 0] * fx[:, None] - sx[:, None].float()
    y = kp[:, 1] * fy[:, None] - sy[:, None].float()
    swap = torch.tensor(FLIP_SWAP_19, device=dev)
    f = flips[:, None]
    x = torch.where(f, (float(out) - x - 1.0)[:, swap], x)
    y = torch.where(f, y[:, swap], y)
    vis = (torch.where(f, vis[:, swap], vis) > 0).float()
    lab = torch.stack([(2.0 * (x / out) - 1.0) * vis, (2.0 * (y / out) - 1.0) * vis, vis], dim=-1)
    return crops * 2.0 - 1.0, segs, lab


def silhouette(segs, max_points: int):
    """(points (N, P, 2), prefix mask (N, P)): the pixels with seg > 0,
    visited in the order of the key ((f * 40503) mod 2^16, f) for a crop of
    at most 2^16 pixels, truncated to ``max_points``."""
    n, h, w = segs.shape[:3]
    total = h * w
    if total > 1 << 16:
        raise ValueError("the reference silhouette covers crops of at most 2^16 pixels")
    on = segs.reshape(n, total) > 0
    f = torch.arange(total, device=segs.device, dtype=torch.int64).expand(n, total)
    key = torch.where(on, (((f * 40503) & 0xFFFF) << 16) | f, torch.full_like(f, 1 << 40))
    order = torch.sort(key, dim=1).values[:, :max_points] & 0xFFFF
    valid = f[:, :max_points] < on.sum(dim=1)[:, None]
    order = torch.where(valid, order, 0)
    return torch.stack([order % w, order // w], -1).float(), valid.float()


def prepare(host: dict, cfg: dict, generator=None, augment: bool = True) -> Prepared:
    """One batch of host canvases through the input path; ``augment=False``
    is the centre crop at scale 1."""
    img = host["image"]
    n, dev = img.shape[0], img.device
    if augment:
        trans, scales, flips = draws(n, cfg, generator, dev)
    else:
        trans = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        scales = torch.ones(n, device=dev)
        flips = torch.zeros(n, dtype=torch.bool, device=dev)
    crops, segs, lab = crop(img, host["seg"], host["hw"], host["center"], host["label"], cfg["img_size"],
                            trans, scales, flips)
    pts, mask = silhouette(segs, cfg["max_silhouette_points"])
    return Prepared(crops, pts, mask, lab)
