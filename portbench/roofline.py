"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit) and the bound of the silhouette chamfer.

The chamfer's least time: 7 f32 operations per (valid pixel, vertex) pair
(5 for the shared squared distance, one min per direction) over the f32
peak outside the tensor cores, against each input read once and each
output written once over the memory rate; the larger of the two. The work
is what the inputs need: only valid pixels pair with the vertices.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def chamfer_bound_s(valid_pixels: int, n: int, p: int, v: int, with_grad: bool) -> float:
    """Least seconds of one chamfer call over a batch of ``n`` images with
    ``p`` pixel slots (``valid_pixels`` of them valid in all) and ``v``
    vertices. Inputs: points (n, p, 2) and mask (n, p) f32, vertices (n, v,
    2) f32; outputs: the value (n,) f32 and, ``with_grad``, the vertices'
    gradient (n, v, 2) f32."""
    ops = 7.0 * valid_pixels * v
    nbytes = 4 * (n * p * 2 + n * p + n * v * 2) + 4 * n + (4 * n * v * 2 if with_grad else 0)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
