"""Host-side image helpers for inference/demo preprocessing (the port's
own copy of ``human_pose_estimation_tpu/utils/image.py``).

Scale an image, center-crop it to the model input size with edge padding,
and report the proc_param that viz.renderer.get_original needs to undo the
transform; decode an uploaded image (``decode_image``). OpenCV is imported
inside the functions that resize or read images, never with this module.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels: gray, RGB, RGBA


def decode_image(raw: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, as ``cv2.imdecode(...,
    IMREAD_COLOR)`` and ``COLOR_BGR2RGB`` give it.

    One decoder per format, chosen by the file signature: an 8-bit,
    non-interlaced gray, RGB or RGBA PNG is decoded here with zlib and
    numpy (gray is repeated into three channels, alpha is dropped, as
    IMREAD_COLOR does); every other input (JPEG, and the other PNG forms)
    goes to OpenCV, imported here. Raises ValueError when it cannot be
    decoded.
    """
    if raw[:8] == _PNG_SIGNATURE:
        header = _png_header(raw)
        if header is not None:
            return _decode_png(raw, *header)
    import cv2

    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _png_chunks(raw: bytes):
    pos = 8
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos : pos + 8])
        yield kind, raw[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _png_header(raw: bytes):
    """(height, width, channels) of a PNG this module decodes, else None."""
    kind, ihdr = next(_png_chunks(raw), (None, b""))
    if kind != b"IHDR" or len(ihdr) != 13:
        raise ValueError("could not decode image: a PNG without its IHDR")
    width, height, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        return None
    return height, width, _PNG_CHANNELS[colour]


def _unfilter_sequential(kind: int, line, prior, bpp: int):
    """The Average (3) and Paeth (4) row filters undone on Python ints:
    each byte depends on the one ``bpp`` to its left."""
    cur = [0] * len(line)
    for i, v in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (v + pred) & 0xFF
    return cur


def _decode_png(raw: bytes, height: int, width: int, channels: int) -> np.ndarray:
    data = b"".join(body for kind, body in _png_chunks(raw) if kind == b"IDAT")
    try:
        flat = np.frombuffer(zlib.decompress(data), np.uint8)
    except zlib.error as e:
        raise ValueError(f"could not decode image: {e}") from e
    stride = width * channels
    if flat.size < height * (stride + 1):
        raise ValueError("could not decode image: truncated PNG data")
    rows = flat[: height * (stride + 1)].reshape(height, stride + 1)
    kinds, lines = rows[:, 0], rows[:, 1:]
    if (kinds > 4).any():
        raise ValueError(f"could not decode image: PNG row filter {int(kinds.max())}")
    # uint8 arithmetic wraps modulo 256, as the filters' sums do
    out = np.zeros((height + 1, stride), np.uint8)  # row 0: the zero row above the image
    # None and Sub rows depend on no other row: all at once (Sub is a
    # running sum per channel along the row) ...
    out[1:][kinds == 0] = lines[kinds == 0]
    sub = kinds == 1
    out[1:][sub] = np.cumsum(lines[sub].reshape(-1, width, channels), axis=1, dtype=np.uint8).reshape(-1, stride)
    # ... then the rows that read the row above, in order
    for y in np.flatnonzero(kinds >= 2):
        kind, line, prior = kinds[y], lines[y], out[y]
        if kind == 2:  # Up
            out[y + 1] = line + prior
        else:  # Average, Paeth: byte by byte along the row
            out[y + 1] = _unfilter_sequential(kind, line.tolist(), prior.tolist(), channels)
    img = out[1:].reshape(height, width, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def resize_img(img: np.ndarray, scale_factor: float):
    import cv2

    new_size = (
        int(round(img.shape[1] * scale_factor)),
        int(round(img.shape[0] * scale_factor)),
    )
    resized = cv2.resize(img, new_size)
    actual = np.array(
        [new_size[1] / float(img.shape[0]), new_size[0] / float(img.shape[1])]
    )
    return resized, actual


def scale_and_crop(
    image: np.ndarray, scale: float, center: np.ndarray, img_size: int
) -> Tuple[np.ndarray, Dict]:
    """Scale then crop img_size x img_size around center (edge-padded).

    Returns (crop, proc_param) with proc_param = {scale, start_pt, end_pt,
    img_size} consumed by get_original.
    """
    image_scaled, scale_factors = resize_img(image, scale)
    center_scaled = np.round(center * scale_factors[::-1]).astype(int)

    margin = int(img_size / 2)
    image_pad = np.pad(
        image_scaled, ((margin,), (margin,), (0,)), mode="edge"
    )
    center_pad = center_scaled + margin
    start_pt = center_pad - margin
    end_pt = center_pad + margin
    crop = image_pad[start_pt[1] : end_pt[1], start_pt[0] : end_pt[0], :]
    proc_param = {
        "scale": scale,
        "start_pt": start_pt,
        "end_pt": end_pt,
        "img_size": img_size,
    }
    return crop, proc_param


def preprocess_for_inference(
    img: np.ndarray, img_size: int = 224
) -> Tuple[np.ndarray, Dict, np.ndarray]:
    """Demo-path preprocessing (ref preview.py:18-35): scale the longest
    side to img_size, center-crop, normalize to [-1, 1]."""
    if img.shape[2] == 4:
        img = img[:, :, :3]
    scale = float(img_size) / np.max(img.shape[:2])
    center = np.round(np.array(img.shape[:2])[::-1] / 2.0).astype(int)
    crop, proc_param = scale_and_crop(img, scale, center, img_size)
    norm = 2.0 * (crop.astype(np.float32) / 255.0) - 1.0
    return norm, proc_param, img


def load_calibration_images(
    pattern, img_size: int = 224, limit: int = 16
) -> "np.ndarray | None":
    """Load + preprocess up to `limit` images — from a glob pattern or an
    explicit path list — into an (N, img_size, img_size, 3) float batch
    in [-1, 1]: the int8 activation-scale calibration input shared by the
    predict / serve / export_model CLIs. Unreadable files are skipped;
    returns None when nothing loads."""
    import cv2

    if isinstance(pattern, (list, tuple)):
        paths = list(pattern)[:limit]
    else:
        from glob import glob

        paths = sorted(glob(pattern))[:limit]
    imgs = []
    for p in paths:
        raw = cv2.imread(p)
        if raw is None:
            continue
        imgs.append(
            preprocess_for_inference(
                cv2.cvtColor(raw, cv2.COLOR_BGR2RGB), img_size
            )[0]
        )
    if not imgs:
        return None
    return np.stack(imgs)
