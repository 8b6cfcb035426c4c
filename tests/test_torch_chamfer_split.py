"""The split decompositions of the chamfer kernels as plain torch models:
the value-and-gradient kernels (K2/K3/K4, ``csrc/chamfer_bwd.cu``) held
against their plain version (``chamfer_bwd_parts_reference``), and the
value-only kernel (K1, ``csrc/chamfer_fwd.cu``, the end of this file) held
against its own (``chamfer_forward_parts_reference``); each also against
its Pallas kernel in interpret mode.

The CUDA source runs the pass as four launches. Within a chunk it walks
the vertices (or pixels) by groups of ``kGroup``, counted from the chunk's
start, and keeps the first group whose min is below the running min
(strict ``<``):

1. assign: per (pixel, vertex chunk), the chunk's min ``d`` and the first
   group that reaches it;
2. assign merge: the first vertex chunk that holds the min (strict ``<``
   in chunk order), then the first of the ``kGroup`` vertices from the
   start of its group whose ``d`` equals it, which is the first nearest
   vertex over all vertices; then each pixel's ``mask * sign`` and masked
   L1 at that vertex;
3. vertex: per (vertex, pixel chunk), the chunk's min ``d`` over the
   pixels with mask > 0, the first group that reaches it, and the sum of
   ``-mask * sign`` over the pixels assigned to the vertex; chunks at or
   past the image's last active pixel are not walked;
4. vertex merge: the walked pixel chunks in order, strict ``<`` on the min,
   the L1 sums added in chunk order; then the first of the ``kGroup``
   pixels from the start of the winning group with mask > 0 whose ``d``
   equals the min, and the L2 unit vector.

``split_model`` does the same with tensor ops for any chunk sizes and the
source's ``kGroup``, so the decomposition is checked here although the
kernels run only on the card.

Tolerances: the L1 gradient, ``vmin`` and the L2 gradient bit for bit
against the plain version (the same IEEE operations and selections; with
binary masks the L1 gradient is an integer per vertex, so its order of
summation does not change it); the value at rtol 1e-5 (its terms are
summed in another order). Against the Pallas kernel in interpret mode the
tolerances of tests/test_torch_chamfer_grad.py: L1 gradient exactly, L2
gradient atol 1e-6, value rtol 1e-5.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from human_pose_estimation_tpu.ops.pallas_chamfer import _chamfer_forward, _run_bwd_kernel
from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

N, P, V = 4, 128, 112


def _source_group(name: str) -> int:
    """The ``kGroup`` that a kernel source is compiled with."""
    return int(re.search(r"constexpr int kGroup = (\d+);", (cc._CSRC / name).read_text()).group(1))


# pixels or vertices per group of the kernels' bookkeeping of the first index
GROUP = _source_group("chamfer_bwd.cu")
FWD_GROUP = _source_group("chamfer_fwd.cu")  # vertices per group of K1's pixel pass
# (pixel chunk, vertex chunk): 1, 7 and 64, and 48, which divides neither P nor V
CHUNKS = [(1, 1), (7, 7), (64, 64), (48, 48), (7, 64), (64, 7)]


def _chunked(x: torch.Tensor, size: int, dim: int, fill) -> torch.Tensor:
    """``x`` padded along ``dim`` to a multiple of ``size`` with ``fill``,
    then that dimension split into (chunks, size)."""
    pad = (-x.shape[dim]) % size
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, torch.full(shape, fill, dtype=x.dtype)], dim=dim)
    return x.unflatten(dim, (x.shape[dim] // size, size))


def _first_group(mins: torch.Tensor, dim: int, start: float):
    """(min, index of the first group at it) over ``dim`` of per-group
    mins, walked in order with a strict ``<`` from ``start``."""
    best = torch.full(mins.select(dim, 0).shape, start)
    at = torch.zeros(best.shape, dtype=torch.long)
    for i in range(mins.shape[dim]):
        take = mins.select(dim, i) < best
        best = torch.where(take, mins.select(dim, i), best)
        at = torch.where(take, i, at)
    return best, at


def _first_equal(
    d: torch.Tensor, start: torch.Tensor, target: torch.Tensor, eligible: torch.Tensor, dim: int, group: int = GROUP
):
    """Index of the first of the ``group`` entries of ``d`` along ``dim``
    from ``start`` (within the dimension, and ``eligible``) whose value
    equals ``target``: the merges' rescan of one group."""
    size = d.shape[dim]
    idx = start.unsqueeze(dim) + torch.arange(group).view([group if k == dim else 1 for k in range(d.dim())])
    inside = idx < size
    idx = idx.clamp_max(size - 1)
    hit = inside & eligible.expand_as(d).gather(dim, idx) & (d.gather(dim, idx) == target.unsqueeze(dim))
    return start + hit.float().argmax(dim=dim)


def split_model(gt, mask, pred, pixel_chunk: int, vertex_chunk: int) -> cc.BwdParts:
    """The four launches of csrc/chamfer_bwd.cu in plain torch."""
    gt, mask, pred = gt.float(), mask.float(), pred.float()
    n, p, _ = gt.shape
    v = pred.shape[1]
    inf = float("inf")
    counts = cc.last_active(mask).long()
    walked = torch.arange(p)[None, :] < counts[:, None]  # (N, P)
    dx = gt[:, :, None, 0] - pred[:, None, :, 0]  # (N, P, V)
    dy = gt[:, :, None, 1] - pred[:, None, :, 1]
    d = dx * dx + dy * dy

    # 1. assign: per (pixel, vertex chunk) the chunk's min and the first
    # group of the chunk that reaches it
    dc = _chunked(d, vertex_chunk, 2, inf)  # (N, P, VC, vc)
    gmin = _chunked(dc, GROUP, 3, inf).amin(dim=4)  # (N, P, VC, groups)
    part_d, part_group = _first_group(gmin, 3, inf)  # (N, P, VC)

    # 2. assign merge: the first chunk at the min (strict `<` in chunk
    # order), then the first vertex of its group at it
    dmin, first = _first_group(part_d, 2, inf)
    found = dmin < inf
    group = part_group.gather(2, first[..., None])[..., 0]
    j0 = first * vertex_chunk + group * GROUP
    best = torch.where(found, _first_equal(d, j0, dmin, torch.ones(()).bool(), 2), -1)
    assigned = walked & (mask != 0) & (best >= 0)
    near = best.clamp_min(0)[..., None]
    ndx = dx.gather(2, near)[..., 0]
    ndy = dy.gather(2, near)[..., 0]
    zero = torch.zeros(())
    signs = torch.stack(
        [torch.where(assigned, mask * torch.sign(ndx), zero), torch.where(assigned, mask * torch.sign(ndy), zero)],
        dim=-1,
    )  # (N, P, 2)
    l1_value = torch.where(assigned, mask * ndx.abs() + mask * ndy.abs(), zero).sum(dim=1)
    assign = torch.where(assigned, best, -1)

    # 3. vertex: per (vertex, pixel chunk) the chunk's min over mask > 0,
    # the first group of the chunk that reaches it, and the signs of the
    # pixels assigned to the vertex
    eligible = walked & (mask > 0)
    d_masked = torch.where(eligible[..., None], d, torch.full((), cc.BIG))
    dm = _chunked(d_masked, pixel_chunk, 1, cc.BIG)  # (N, PC, pc, V)
    gmin = _chunked(dm, GROUP, 2, cc.BIG).amin(dim=3)  # (N, PC, groups, V)
    part_vmin, part_vgroup = _first_group(gmin, 2, cc.BIG)  # (N, PC, V)
    onehot = (assign[..., None] == torch.arange(v)).float()  # (N, P, V)
    part_l1 = _chunked(-(onehot[..., None] * signs[:, :, None, :]), pixel_chunk, 1, 0.0).sum(dim=2)

    # 4. vertex merge: the walked chunks in order, then the first eligible
    # pixel of the winning chunk's group at the min
    n_walked = (counts + pixel_chunk - 1) // pixel_chunk
    vmin = torch.full((n, v), cc.BIG)
    first = torch.zeros((n, v), dtype=torch.long)
    l1_grad = torch.zeros((n, v, 2))
    for c in range(part_vmin.shape[1]):
        on = (c < n_walked)[:, None]
        take = on & (part_vmin[:, c] < vmin)
        vmin = torch.where(take, part_vmin[:, c], vmin)
        first = torch.where(take, c, first)
        l1_grad = torch.where(on[..., None], l1_grad + part_l1[:, c], l1_grad)
    i0 = first * pixel_chunk + part_vgroup.gather(1, first[:, None])[:, 0] * GROUP
    at_min = _first_equal(d, i0, vmin, (mask > 0)[..., None], 1)
    bi = torch.where(vmin < cc.BIG / 2, at_min, 0)
    delta = pred - gt.gather(1, bi[..., None].expand(-1, -1, 2))
    norm = torch.sqrt((delta * delta).sum(dim=-1, keepdim=True))
    l2_grad = torch.where(norm > 1e-12, delta / norm.clamp_min(1e-12), torch.zeros_like(delta))
    l2_grad = torch.where((vmin < cc.BIG / 2)[..., None], l2_grad, torch.zeros_like(l2_grad))
    return cc.BwdParts(l1_value, vmin, l1_grad, l2_grad)


def _first_boundary(chunk: int, at_least: int) -> int:
    """The first chunk boundary at or past ``at_least``."""
    return -(-at_least // chunk) * chunk


def _split_case(pixel_chunk: int, vertex_chunk: int, seed: int = 0):
    """Four images: holes throughout and an early end (0), an empty mask
    (1), a mask whose first chunks are all zero and whose last pixel is
    alone (2), and (3) exact ties: pixel 0 is d=25 from vertices k-1 and
    k, the last of one vertex chunk and the first of the next; vertex V-1
    is d=25 from pixels j-1 and j, the last of one pixel chunk and the
    first of the next; inside one chunk where it holds three or more,
    pixel P-1 from vertices k+1 and k+2, vertex V-2 from pixels j+1 and
    j+2; and across a group boundary inside one chunk where it holds more
    than a group, pixel P-2 from vertices k+GROUP-1 and k+GROUP, vertex V-3
    from pixels j+GROUP-1 and j+GROUP. Returns numpy arrays and (k, j)."""
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 64, (N, P, 2)).astype(np.float32)
    pred = (rng.rand(N, V, 2) * 64).astype(np.float32)
    mask = (rng.rand(N, P) > 0.3).astype(np.float32)
    mask[0, 90:] = 0.0
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, 100:111] = 1.0
    mask[2, P - 1] = 1.0
    k = _first_boundary(vertex_chunk, 1)
    gt[3, 0] = [-100.0, -100.0]
    mask[3, 0] = 1.0
    pred[3, k - 1] = [-97.0, -96.0]  # d = 9 + 16, L1 7
    pred[3, k] = [-95.0, -100.0]  # d = 25 + 0, L1 5
    j = _first_boundary(pixel_chunk, 2)
    gt[3, j - 1] = [203.0, 204.0]
    gt[3, j] = [204.0, 203.0]
    mask[3, [j - 1, j]] = 1.0
    pred[3, V - 1] = [200.0, 200.0]
    gt[3, P - 1] = [-300.0, -300.0]
    mask[3, P - 1] = 1.0
    pred[3, k + 1] = [-297.0, -296.0]
    pred[3, k + 2] = [-295.0, -300.0]
    gt[3, j + 1] = [303.0, 304.0]
    gt[3, j + 2] = [304.0, 303.0]
    mask[3, [j + 1, j + 2]] = 1.0
    pred[3, V - 2] = [300.0, 300.0]
    gt[3, P - 2] = [-500.0, 500.0]
    mask[3, P - 2] = 1.0
    pred[3, k + GROUP - 1] = [-497.0, 504.0]
    pred[3, k + GROUP] = [-495.0, 500.0]
    gt[3, j + GROUP - 1] = [703.0, 704.0]
    gt[3, j + GROUP] = [704.0, 703.0]
    mask[3, [j + GROUP - 1, j + GROUP]] = 1.0
    pred[3, V - 3] = [700.0, 700.0]
    return gt, mask, pred, k, j


def _check_ties(parts: cc.BwdParts, k: int, j: int) -> None:
    l1, l2 = parts.l1_grad.numpy(), parts.l2_grad.numpy()
    # the vertex ties: only the lower index takes the pixel
    for first in (k - 1, k + 1, k + GROUP - 1):
        np.testing.assert_array_equal(l1[3, first], [1.0, 1.0])
        np.testing.assert_array_equal(l1[3, first + 1], [0.0, 0.0])
    # the pixel ties: both pixels are assigned to the vertex, whose unit
    # vector points from the earlier one
    for vert in (V - 1, V - 2, V - 3):
        np.testing.assert_array_equal(l1[3, vert], [-2.0, -2.0])
        np.testing.assert_allclose(l2[3, vert], [-0.6, -0.8], rtol=0, atol=1e-6)


@pytest.mark.parametrize("pixel_chunk,vertex_chunk", CHUNKS)
def test_split_model_matches_plain_version(pixel_chunk, vertex_chunk):
    gt, mask, pred, k, j = _split_case(pixel_chunk, vertex_chunk)
    args = [torch.from_numpy(a) for a in (gt, mask, pred)]
    out = split_model(*args, pixel_chunk, vertex_chunk)
    ref = cc.chamfer_bwd_parts_reference(*args, chunk=32)
    assert torch.equal(out.l1_grad, ref.l1_grad)
    assert torch.equal(out.vmin, ref.vmin)
    assert torch.equal(out.l2_grad, ref.l2_grad)
    np.testing.assert_allclose(out.l1_value.numpy(), ref.l1_value.numpy(), rtol=1e-5)
    assert float(out.l1_value[1]) == 0.0 and float(out.l1_grad[1].abs().max()) == 0.0
    assert bool((out.vmin[1] == cc.BIG).all()) and float(out.l2_grad[1].abs().max()) == 0.0
    _check_ties(out, k, j)


@pytest.mark.parametrize("pixel_chunk,vertex_chunk", CHUNKS)
def test_split_model_matches_pallas(pixel_chunk, vertex_chunk):
    gt, mask, pred, k, j = _split_case(pixel_chunk, vertex_chunk, seed=1)
    out = split_model(*(torch.from_numpy(a) for a in (gt, mask, pred)), pixel_chunk, vertex_chunk)
    l1g, l2g, _, vmin, l1v = _run_bwd_kernel(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 32, True, with_value=True
    )
    np.testing.assert_array_equal(out.l1_grad.numpy(), np.asarray(l1g))
    np.testing.assert_allclose(out.l2_grad.numpy(), np.asarray(l2g), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.vmin.numpy(), np.asarray(vmin), rtol=1e-6)
    np.testing.assert_allclose(out.l1_value.numpy(), np.asarray(l1v), rtol=1e-5)
    _check_ties(out, k, j)


# K1, the value-only kernel (csrc/chamfer_fwd.cu). Its pixel pass and pixel
# merge are K2's assign pass and assign merge, with its own kGroup; its
# vertex pass keeps only the min; a count launch before the passes and a
# finish launch after them do what the wrapper did in torch:
#
# 0. count: per image, one past the last pixel with mask > 0 and whether
#    the mask sums above 0;
# 1. pixel pass: per (pixel, vertex chunk), the chunk's min ``d`` and the
#    first group of FWD_GROUP vertices that reaches it;
# 2. pixel merge: the first vertex chunk at the min (strict ``<``), the
#    first vertex of its group whose ``d`` equals it, and the pixel's
#    ``(|dx| + |dy|) * mask`` there, for the walked pixels with mask != 0;
# 3. vertex pass: per (vertex, pixel chunk), the min of ``d`` over the
#    walked pixels with mask > 0 and 1e30;
# 4. vertex merge: the min over the walked chunks, and ``sqrt(vmin)`` where
#    a pixel was found;
# 5. finish: the L1 and the sqrt terms summed, 0 where the mask does not
#    sum above 0.


def split_forward_model(gt, mask, pred, pixel_chunk: int, vertex_chunk: int):
    """The launches of csrc/chamfer_fwd.cu in plain torch: (N,) value, (N,)
    L1 and (N, V) vmin."""
    gt, mask, pred = gt.float(), mask.float(), pred.float()
    n, p, _ = gt.shape
    v = pred.shape[1]
    inf = float("inf")
    big = torch.full((), cc.BIG)

    # 0. count
    counts = cc.last_active(mask).long()
    has_gt = mask.sum(dim=1) > 0
    walked = torch.arange(p)[None, :] < counts[:, None]  # (N, P)
    dx = gt[:, :, None, 0] - pred[:, None, :, 0]  # (N, P, V)
    dy = gt[:, :, None, 1] - pred[:, None, :, 1]
    d = dx * dx + dy * dy

    # 1. pixel pass
    dc = _chunked(d, vertex_chunk, 2, inf)  # (N, P, VC, vc)
    gmin = _chunked(dc, FWD_GROUP, 3, inf).amin(dim=4)  # (N, P, VC, groups)
    part_d, part_group = _first_group(gmin, 3, inf)  # (N, P, VC)

    # 2. pixel merge
    dmin, first = _first_group(part_d, 2, inf)
    j0 = first * vertex_chunk + part_group.gather(2, first[..., None])[..., 0] * FWD_GROUP
    near = _first_equal(d, j0, dmin, torch.ones(()).bool(), 2, FWD_GROUP)[..., None]
    l1_near = dx.gather(2, near)[..., 0].abs() + dy.gather(2, near)[..., 0].abs()
    weighted = walked & (mask != 0) & (dmin < inf)
    l1 = torch.where(weighted, l1_near * mask, torch.zeros(())).sum(dim=1)

    # 3. vertex pass
    d_masked = torch.where((walked & (mask > 0))[..., None], d, torch.full((), inf))
    part_vmin = torch.minimum(_chunked(d_masked, pixel_chunk, 1, inf).amin(dim=2), big)  # (N, PC, V)

    # 4. vertex merge
    n_walked = (counts + pixel_chunk - 1) // pixel_chunk
    vmin = big.expand(n, v)
    for c in range(part_vmin.shape[1]):
        vmin = torch.where((c < n_walked)[:, None], torch.minimum(vmin, part_vmin[:, c]), vmin)
    l2 = torch.where(vmin < cc.BIG / 2, torch.sqrt(vmin.clamp_min(0.0)), torch.zeros(())).sum(dim=1)

    # 5. finish
    value = torch.where(has_gt, l1 + l2, torch.zeros(()))
    return value, l1, vmin


def _fwd_split_case(vertex_chunk: int, seed: int = 0):
    """Four images: (0) holes throughout, an early end, and fractional and
    negative weights before it; (1) an empty mask; (2) a mask whose first
    chunks are all zero and whose last pixel is alone; (3) two weighted
    pixels only, each exactly d=25 from two vertices with L1 7 (the first)
    and 5: pixel 0 from vertices k-1 and k, the last of one vertex chunk and
    the first of the next, and pixel 1 from vertices k+FWD_GROUP-1 and
    k+FWD_GROUP, across a group boundary inside one chunk where it holds
    more than a group. Its L1 is 14 when the first vertex wins both ties.
    Returns numpy arrays and k."""
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 64, (N, P, 2)).astype(np.float32)
    pred = (rng.rand(N, V, 2) * 64).astype(np.float32)
    mask = (rng.rand(N, P) > 0.3).astype(np.float32)
    mask[0] *= rng.choice(np.float32([1.0, 1.0, 0.5, 0.25, -0.5, -2.0]), P)
    mask[0, 90:] = 0.0
    mask[0, 89] = 1.0
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, 100:111] = 1.0
    mask[2, P - 1] = 1.0
    mask[3] = 0.0
    k = _first_boundary(vertex_chunk, 1)
    gt[3, 0] = [-100.0, -100.0]
    pred[3, k - 1] = [-97.0, -96.0]  # d = 9 + 16, L1 7
    pred[3, k] = [-95.0, -100.0]  # d = 25 + 0, L1 5
    gt[3, 1] = [-500.0, 500.0]
    pred[3, k + FWD_GROUP - 1] = [-497.0, 504.0]
    pred[3, k + FWD_GROUP] = [-495.0, 500.0]
    mask[3, :2] = 1.0
    assert (mask[0] < 0).any() and ((mask[0] > 0) & (mask[0] < 1)).any() and mask[0].sum() > 0
    return gt, mask, pred, k


@pytest.mark.parametrize("pixel_chunk,vertex_chunk", CHUNKS)
def test_split_forward_model_matches_plain_version(pixel_chunk, vertex_chunk):
    """vmin bit for bit (a min has no order), the L1 and the value at rtol
    1e-5 (summed in another order); the ties on the first vertex; the
    negative weights count in the pixel direction and not in the vertex
    direction, as in the plain version."""
    gt, mask, pred, _ = _fwd_split_case(vertex_chunk)
    args = [torch.from_numpy(a) for a in (gt, mask, pred)]
    value, l1, vmin = split_forward_model(*args, pixel_chunk, vertex_chunk)
    ref_l1, ref_vmin = cc.chamfer_forward_parts_reference(*args, chunk=32)
    assert torch.equal(vmin, ref_vmin)
    np.testing.assert_allclose(l1.numpy(), ref_l1.numpy(), rtol=1e-5)
    np.testing.assert_allclose(value.numpy(), cc.chamfer_forward_reference(*args, chunk=32).numpy(), rtol=1e-5)
    assert float(value[1]) == 0.0 and bool((vmin[1] == cc.BIG).all())
    assert float(l1[3]) == 14.0
    positive = args[1].clamp_min(0.0)
    assert torch.equal(cc.chamfer_forward_parts_reference(args[0], positive, args[2], chunk=32)[1], vmin)
    assert abs(float(l1[0]) - float(cc.chamfer_forward_parts_reference(args[0], positive, args[2])[0][0])) > 1.0


@pytest.mark.parametrize("pixel_chunk,vertex_chunk", CHUNKS)
def test_split_forward_model_matches_pallas(pixel_chunk, vertex_chunk):
    """The value against the Pallas forward kernel in interpret mode, rtol
    1e-5."""
    gt, mask, pred, _ = _fwd_split_case(vertex_chunk, seed=1)
    value, l1, _ = split_forward_model(*(torch.from_numpy(a) for a in (gt, mask, pred)), pixel_chunk, vertex_chunk)
    pallas = _chamfer_forward(jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(pred), 32, True)
    np.testing.assert_allclose(value.numpy(), np.asarray(pallas), rtol=1e-5)
    assert float(value[1]) == 0.0 and float(l1[3]) == 14.0
