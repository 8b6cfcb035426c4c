#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version at the shape of the main path (K1, the value-only chamfer; K2/K3,
the value-and-gradient chamfer and its gradient-only launch; K4, K2 with
f32 index carriers; with exact ties inside and across the chunks of the
split passes) and prints K1's and K2's device time per launch of their
kernels, then drives the port's main path at full width: the
serving ``Predictor``, the evaluation ``make_val_step`` and the training
``make_train_step``, counting each kernel's launches over the three; then
the on-device input path: ``make_fused_train_step`` from pinned uint8
canvases and the raw mocap stream of ``NpzMocapPipeline`` (``[fused-train]``),
the augmentation and silhouettes on the card against the CPU
(``[augment-parity]``), ``make_multi_step`` against sequential steps
(``[multi-step]``) and the rematerialised encoder against the plain one
(``[remat]``), each with its kernels' launches counted; the training loop
(``[trainer]``); the closed loop (``[closed-loop]``): the full hybrid
recipe trained through ``Trainer`` on rendered synthetic humans (the C++
rasterizer, built with g++) at the quality bench's ``combined``
configuration and evaluated against the parameters that generated them;
then the int8 encoder and the serving stack: the
post-training int8 encoder at full width against bf16 and f32 and
against itself on the CPU (``[int8]``), the int8 graph under evaluation
with K1's launches counted and ``validate_checkpoint`` on ``[trainer]``'s
checkpoint (``[int8-eval]``), ``BatchingPredictor`` at pipeline depths 1
and 2 (``[batching]``), the HTTP server under a client process
(``[http]``) and the ``torch.export`` artifacts for ``cuda`` and ``cpu``,
loaded again in a fresh process (``[export]``); data parallelism in
child processes (``[data-parallel]``); the weight importers'
TensorFlow-free halves on stand-in Keras models at full width (a donor
grafted into a training ``Trainer``, a reference bundle restored by a
``Predictor`` and swept by ``validate_checkpoint``) and the s2d stem
against the standard one (``[weights]``); and last holds one f64
training step on the card against the same step on the CPU. Every phase
prints one line; any failure raises and the script exits non-zero.
The line before the last is a JSON object with one entry per ported
kernel; the last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA device and
exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM bandwidth; the bound of a kernel is the larger of
# its operations over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_cuda(fn, iters: int, warmup: int = 3, queued: bool = False, batch: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` calls, timed with CUDA
    events after ``warmup`` calls. By default the calls run back to back,
    and the events see whichever of the host and the device is slower (the
    ``ms`` of the kernels line). With ``queued`` the calls go in batches of
    ``batch``, and before each the device is held in a spin kernel for
    longer than the host takes to enqueue the batch, so that the events see
    device time alone, without gaps where the device waits for the host
    (``device_ms``; a batch of 20 calls stays within the device's queue of
    pending launches, past which the host would block and pace the device
    again)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not queued:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # an upper bound of the host's time per call
    total_ms, done = 0.0, 0
    while done < iters:
        n = min(batch, iters - done)
        torch.cuda._sleep(int(2e9 * (0.002 + 2 * host_s * n)))  # cycles, at up to 2 GHz
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        total_ms += start.elapsed_time(end)
        done += n
    return total_ms / iters


SMOKE_DIR = os.path.join(HERE, "build", "smoke")  # git-ignored
MOCAP_SHARD = os.path.join(SMOKE_DIR, "neutrSMPL_smoke_0.npz")

K1_KERNELS = ("fwd_count", "fwd_pixel_pass", "fwd_pixel_merge", "fwd_vertex_pass", "fwd_vertex_merge", "fwd_finish")
K2_KERNELS = ("assign_kernel", "assign_merge_kernel", "vertex_kernel", "vertex_merge_kernel")


def _ptxas_summary(log: str) -> str:
    """'kernel<args>: N registers, B bytes smem, S spill stores' per entry
    function, from nvcc's -Xptxas -v output."""
    import re

    names = "|".join(K1_KERNELS + K2_KERNELS)
    parts, name, spills = [], None, "?"
    for line in log.splitlines():
        m = re.search(rf"Compiling entry function '_Z\w*?\d+({names})(?:I((?:[if]|L[ib]\d+E)+)E)?", line)
        if m:
            args = [
                {"i": "int", "f": "float"}[t] if t else ({"0": "false", "1": "true"}[n] if k == "b" else n)
                for k, n, t in re.findall(r"L([ib])(\d+)E|([if])", m.group(2) or "")
            ]
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)  # no smem: no smem field
        if m and name:
            parts.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} B smem, {spills} B spilled")
            name = None
    return "; ".join(parts) or "ptxas output not found"


def _device_breakdown(torch, fn, wall_ms: float, label: str = "K1", names=K1_KERNELS, span=None) -> str:
    """Summed CUDA kernel time of one call of ``fn`` under torch.profiler,
    against ``wall_ms`` (the same call timed without the profiler): the
    device's busy share, the three largest kernels and the share of the
    kernels whose names contain one of ``names``; with ``span``, also the
    device time of the kernels launched inside the ``record_function``
    range of that name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a record_function range (Optimizer.step, step.prep) also has
    # a CUDA row that spans its kernels on the device's timeline, gaps
    # included: not device work, so left out as torch's own totals do
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    if not rows:
        return "device time not measured (the profiler saw no CUDA kernel)"
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if any(k in r[0] for k in names))
    top = sorted(rows, key=lambda r: -r[1])[:3]
    tops = ", ".join(f"{r[0][:48]} {r[1]:.3f} ms x{r[2]}" for r in top)
    spans = ""
    if span is not None:
        span_ms = sum(
            e.device_time_total / 1e3
            for e in prof.key_averages()
            if e.key == span and e.device_type == torch.autograd.DeviceType.CPU
        )
        spans = f", {span} {span_ms:.3f} ms" if span_ms > 0 else f", {span} not measured (no device time under it)"
    return (
        f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[2] for r in rows)} kernel launches, {label} {ours:.3f} ms "
        f"({100 * ours / wall_ms:.1f}% of the wall){spans}; top: {tops}"
    )


def _profiled_device_ms(torch, fn, calls: int = 5):
    """(device ms per call, launches per call) of ``fn`` over ``calls``
    calls under torch.profiler: the kernels' and copies' own device time,
    record_function ranges left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    return sum(e.self_device_time_total for e in rows) / 1e3 / calls, sum(e.count for e in rows) / calls


def _host_syncs(torch, fn) -> int:
    """The calls that made the host wait for the device during one call of
    ``fn``, as torch's synchronisation debug mode reports them (a
    prototype: it may miss some)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def _eval_silhouettes(gen, n, p, counts, img_size):
    """Prefix silhouettes: ``counts[b]`` valid integer pixel coordinates
    first, zeros after (the layout extract_silhouette produces)."""
    import torch

    pts = torch.randint(0, img_size, (n, p, 2), generator=gen).float()
    mask = torch.zeros(n, p)
    for b, c in enumerate(counts):
        mask[b, :c] = 1.0
    pts = pts * mask[..., None]
    return pts, mask


def _kernel_inputs(torch):
    """The kernels' shared test inputs at the training / evaluation shape:
    five prefix masks of 2k-9k pixels, an empty mask, a non-prefix mask (a
    prefix, an island and a lone last pixel) and an exact tie."""
    n, p, v, img = 8, 16384, 6890, 224
    gen = torch.Generator().manual_seed(0)
    counts = [2048, 4100, 9000, 3100, 5200, 0, 0, 4000]
    gt, mask = _eval_silhouettes(gen, n, p, counts, img)
    mask[6, :17] = 1.0
    mask[6, 500:540] = 1.0
    mask[6, p - 1] = 1.0
    gt[6] = torch.randint(0, img, (p, 2), generator=gen).float()
    pred = torch.rand(n, v, 2, generator=gen) * img
    # image 7: pixel 0 at (-100, -100) is exactly d=25 from vertices 0
    # (L1 7) and 1 (L1 5), far from everything else: the first must win
    gt[7, 0] = torch.tensor([-100.0, -100.0])
    pred[7, 0] = torch.tensor([-97.0, -96.0])
    pred[7, 1] = torch.tensor([-95.0, -100.0])
    return gt.cuda(), mask.cuda(), pred.cuda()


def _bound(torch, cc, gt, mask, pred, out_bytes, in_extra=0):
    """(bound_ms, 'operations' | 'bytes'): 7 f32 operations per (valid
    pixel, vertex) pair (5 for the shared distance, one min per
    direction) over the f32 peak, against each input read once and each
    output written once over the memory rate."""
    pairs = float(mask.sum()) * pred.shape[1]
    ops = 7 * pairs
    nbytes = gt.numel() * 4 + mask.numel() * 4 + pred.numel() * 4 + in_extra + out_bytes
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _pred_to_gt_library_ms(torch, cc, gt, mask, pred, iters, with_indices):
    """The library yardstick for the pred->gt half: one ``torch.cdist``
    and a min over the active pixels (with the nearest pixel's index where
    the kernel needs it), masked pixels moved far away."""
    pmax = int(cc.last_active(mask).max())
    gt_far = torch.where(mask[:, :pmax, None] > 0, gt[:, :pmax], torch.full_like(gt[:, :pmax], 1e6))
    if with_indices:
        return _time_cuda(lambda: torch.cdist(pred, gt_far).min(dim=2), iters=iters)
    return _time_cuda(lambda: torch.cdist(pred, gt_far).amin(dim=2), iters=iters)


def _check_fwd_parts(torch, tag, out, again, ref, ref_value, rtol=1e-5):
    """K1's (value, L1, vmin) against the plain version's (L1, vmin) and
    value: vmin bit-equal, L1 and value within ``rtol`` (summed in another
    order) and finite, two runs bit-identical; returns the value's max
    absolute error."""
    value, l1, vmin = out
    for a, b, field in zip(out, again, ("value", "L1", "vmin")):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: two runs differ in {field}")
    if not torch.equal(vmin, ref[1]):
        raise AssertionError(f"{tag}: vmin is not bit-equal to the plain version")
    for a, b, field in ((l1, ref[0], "L1"), (value, ref_value, "value")):
        if bool(((a - b).abs() > rtol * b.abs()).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag}: the {field} {a.tolist()} differs from the plain version's {b.tolist()}")
    return float((value - ref_value).abs().max())


def _k1_tie(torch, first, v):
    """One image whose one weighted pixel, at (-100, -100), is exactly d=25
    from vertices ``first`` (L1 7) and ``first + 1`` (L1 5), and d=100 from
    the other ``v - 2``: the value is 7 + 10 (v - 2) + 5 + 5 when the first
    vertex wins, 2 less when the second does. Exact in f32."""
    gt = torch.zeros(1, 8, 2, device="cuda")
    gt[0, 0] = torch.tensor([-100.0, -100.0])
    mask = torch.zeros(1, 8, device="cuda")
    mask[0, 0] = 1.0
    pred = torch.tensor([-90.0, -100.0], device="cuda").repeat(1, v, 1)
    pred[0, first] = torch.tensor([-97.0, -96.0])
    pred[0, first + 1] = torch.tensor([-95.0, -100.0])
    return (gt, mask, pred), 7.0 + 10.0 * (v - 2) + 10.0


def phase_kernel(torch, cc, card):
    """K1 against its plain version on the card at the evaluation shape:
    vmin bit-equal, the L1 and the value within rtol 1e-5, two runs
    bit-identical, an empty mask's value 0, and exact ties in isolation
    (vertices 0 and 1, the value 17; across a vertex-chunk boundary and
    across a group boundary inside a vertex chunk of the pixel pass) on the
    first vertex;
    then its times and its device time per launch of its kernels."""
    gt, mask, pred = _kernel_inputs(torch)
    n, p, _ = gt.shape
    v = pred.shape[1]
    ref = cc.chamfer_forward_parts_reference(gt, mask, pred)
    ref_value = cc.chamfer_forward_reference(gt, mask, pred)
    run = lambda: (cc.chamfer_forward(gt, mask, pred), *cc.chamfer_forward_parts(gt, mask, pred))
    out, again = run(), run()
    torch.cuda.synchronize()
    rtol = 1e-5
    max_err = _check_fwd_parts(torch, "K1", out, again, ref, ref_value, rtol)
    if float(out[0][5]) != 0.0:
        raise AssertionError(f"K1 on an empty mask gave {float(out[0][5])}, not 0")

    # the exact ties in isolation: L1 of the FIRST nearest vertex (7) plus
    # the two pred->gt distances (5 + 5), and 10 for every other vertex
    tie_gt = torch.zeros(1, 8, 2, device="cuda")
    tie_mask = torch.zeros(1, 8, device="cuda")
    tie_mask[0, 0] = 1.0
    tie_pred = torch.tensor([[[3.0, 4.0], [5.0, 0.0]]], device="cuda")
    tie = float(cc.chamfer_forward(tie_gt, tie_mask, tie_pred)[0])
    if tie != 17.0:
        raise AssertionError(f"K1 tie case gave {tie}, not 17")
    tiling = cc.fwd_tiling()
    vc, group = tiling["vertex_chunk"], tiling["group"]
    ties = {"across a vertex chunk": vc - 1, "across a group": vc + group - 1}
    for where, first in ties.items():
        inputs, want = _k1_tie(torch, first, first + 2 + group)
        got = float(cc.chamfer_forward(*inputs)[0])
        if got != want:
            raise AssertionError(f"K1 tie {where} (vertices {first}, {first + 1}) gave {got}, not {want}")

    fn = lambda: cc.chamfer_forward(gt, mask, pred)
    ms = _time_cuda(fn, iters=100)
    device_ms = _time_cuda(fn, iters=100, queued=True)
    plain_ms = _time_cuda(lambda: cc.chamfer_forward_reference(gt, mask, pred), iters=5, warmup=1)
    library_ms = _pred_to_gt_library_ms(torch, cc, gt, mask, pred, iters=20, with_indices=False)
    valid = float(mask.sum())
    bound_ms, bound_by = _bound(torch, cc, gt, mask, pred, out_bytes=n * 4)
    split = _per_launch_ms(torch, fn, 20, K1_KERNELS)
    splits = ", ".join(f"{k} {split[k][0]:.4f} ms x{split[k][1]}" for k in K1_KERNELS if k in split)
    print(
        f"[kernel] K1 chamfer_fwd N={n} P={p} V={v} valid={int(valid)}: vmin bit-equal, repeatable, "
        f"empty mask 0, ties on the first vertex (17; {', '.join(f'{w} at {f}' for w, f in ties.items())}) | "
        f"max_abs_err={max_err:.3e} (rtol {rtol}) ms={ms:.4f} (back to back) "
        f"device_ms={device_ms:.4f} (queued ahead of the device) plain_ms={plain_ms:.4f} "
        f"cdist_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) | per launch over 20 calls "
        f"(profiler): {splits or 'not measured (the profiler saw no CUDA kernel)'} | tiling {tiling}, "
        f"resident warps per SM {cc.fwd_resident_warps()} | on {card}",
        flush=True,
    )
    return {
        "name": "chamfer_fwd",
        "route": "cuda",
        "source": "human_pose_estimation_tpu_torch/csrc/chamfer_fwd.cu",
        "replaces": "human_pose_estimation_tpu/ops/pallas_chamfer.py:56",
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _chunk_tie_inputs(gt, mask, pred, pixel_chunk, vertex_chunk, group):
    """Copies of the kernel inputs with exact ties that straddle chunk and
    group boundaries of K2's split passes: pixel 1 of image 3 (3100 valid
    pixels) is d=25 from vertices vertex_chunk-1 (L1 7) and vertex_chunk
    (L1 5), the last of one vertex chunk and the first of the next; pixel
    2 of image 3 is d=25 from vertices vertex_chunk+group-1 and
    vertex_chunk+group, the last of one group and the first of the next
    inside one vertex chunk; vertex 100 of image 2 (9000 valid pixels) is
    d=25 from pixels pixel_chunk-1 and pixel_chunk, the last of one pixel
    chunk and the first of the next; vertex 300 of image 2 is d=25 from
    pixels pixel_chunk+group-1 and pixel_chunk+group, across a group
    boundary inside one pixel chunk; vertex 200 of image 2 is d=25 from
    pixels 2000 and 2001, inside one group. The first index must win
    each."""
    import torch

    gt, mask, pred = gt.clone(), mask.clone(), pred.clone()
    vc, pc = vertex_chunk, pixel_chunk
    gt[3, 1] = torch.tensor([-300.0, -300.0])
    pred[3, vc - 1] = torch.tensor([-297.0, -296.0])
    pred[3, vc] = torch.tensor([-295.0, -300.0])
    gt[3, 2] = torch.tensor([-500.0, 500.0])
    pred[3, vc + group - 1] = torch.tensor([-497.0, 504.0])
    pred[3, vc + group] = torch.tensor([-495.0, 500.0])
    gt[2, pc + group - 1] = torch.tensor([703.0, 704.0])
    gt[2, pc + group] = torch.tensor([704.0, 703.0])
    mask[2, pc + group - 1 : pc + group + 1] = 1.0
    pred[2, 300] = torch.tensor([700.0, 700.0])
    gt[2, pc - 1] = torch.tensor([503.0, 504.0])
    gt[2, pc] = torch.tensor([504.0, 503.0])
    mask[2, pc - 1 : pc + 1] = 1.0
    pred[2, 100] = torch.tensor([500.0, 500.0])
    gt[2, 2000] = torch.tensor([603.0, 604.0])
    gt[2, 2001] = torch.tensor([604.0, 603.0])
    mask[2, 2000:2002] = 1.0
    pred[2, 200] = torch.tensor([600.0, 600.0])
    return gt, mask, pred


def _check_bwd_parts(torch, tag, out, again, ref):
    """The kernel's parts against the plain version's: the L1 gradient and
    vmin bit-equal, the L2 gradient within 1e-6, two runs bit-identical;
    returns the L2 gradient's error."""
    for a, b, field in zip(out, again, out._fields):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{tag}: two runs differ in {field}")
    if not torch.equal(out.l1_grad, ref.l1_grad):
        err = float((out.l1_grad - ref.l1_grad).abs().max())
        raise AssertionError(f"{tag}: the L1 gradient differs from the plain version by {err}")
    l2_err = float((out.l2_grad - ref.l2_grad).abs().max())
    if not l2_err <= 1e-6:
        raise AssertionError(f"{tag}: the L2 gradient differs from the plain version by {l2_err}")
    if not torch.equal(out.vmin, ref.vmin):
        raise AssertionError(f"{tag}: vmin is not bit-equal to the plain version")
    return l2_err


def _per_launch_ms(torch, fn, calls, names):
    """{kernel: (device ms per launch, launches)} of the CUDA kernels
    named in ``names`` over ``calls`` calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    import re

    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        for k in names:
            if re.search(rf"\b{k}[<(]", e.key):
                ms, count = out.get(k, (0.0, 0))
                out[k] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return {k: (ms / count, count) for k, (ms, count) in out.items()}


def phase_kernel_bwd(torch, cc, card):
    """K2 (value and gradient), K3 (gradient only) and K4 (K2 with f32
    index carriers) against their plain version on the card at the
    training shape: value rtol 1e-5, L1 gradient exactly equal, L2
    gradient atol 1e-6, vmin bit-equal, two runs bit-identical, the tie's
    gradient on vertex 0, an empty mask's value and gradient 0, and the
    ties that straddle chunk and group boundaries of the split passes; then
    their times, and K2's device time per launch of its four kernels."""
    gt, mask, pred = _kernel_inputs(torch)
    n = gt.shape[0]
    v = pred.shape[1]
    tiling = cc.bwd_tiling()
    pc, vc, group = tiling["pixel_chunk"], tiling["vertex_chunk"], tiling["group"]
    tie_inputs = _chunk_tie_inputs(gt, mask, pred, pc, vc, group)
    ct = torch.linspace(0.5, 2.0, n, device="cuda")
    ref = cc.chamfer_bwd_parts_reference(gt, mask, pred)
    tie_ref = cc.chamfer_bwd_parts_reference(*tie_inputs)
    ref_value, ref_grad = cc.chamfer_value_and_grad_reference(gt, mask, pred)
    ref_k3 = cc.chamfer_grad_reference(gt, mask, pred, ct)
    variants = (
        ("chamfer_value_and_grad", "K2", True, False, "human_pose_estimation_tpu/ops/pallas_chamfer.py:186"),
        ("chamfer_grad", "K3", False, False, "human_pose_estimation_tpu/ops/pallas_chamfer.py:186"),
        ("chamfer_value_and_grad_f32idx", "K4", True, True, "benchmarks/chamfer_variant_bench.py:45"),
    )
    entries, lines = [], []
    for name, tag, with_value, f32_index, replaces in variants:
        out = cc.chamfer_bwd_parts(gt, mask, pred, with_value, f32_index)
        again = cc.chamfer_bwd_parts(gt, mask, pred, with_value, f32_index)
        torch.cuda.synchronize()
        l2_err = _check_bwd_parts(torch, tag, out, again, ref)
        if out.l1_grad[7, 0].tolist() != [1.0, 1.0] or out.l1_grad[7, 1].tolist() != [0.0, 0.0]:
            raise AssertionError(f"{tag}: the tie's L1 gradient went to {out.l1_grad[7, :2].tolist()}, not vertex 0")
        tie = cc.chamfer_bwd_parts(*tie_inputs, with_value, f32_index)
        tie_again = cc.chamfer_bwd_parts(*tie_inputs, with_value, f32_index)
        l2_err = max(l2_err, _check_bwd_parts(torch, f"{tag} (chunk ties)", tie, tie_again, tie_ref))
        for first in (vc - 1, vc + group - 1):
            if tie.l1_grad[3, first].tolist() != [1.0, 1.0] or tie.l1_grad[3, first + 1].tolist() != [0.0, 0.0]:
                raise AssertionError(
                    f"{tag}: the vertex tie went to {tie.l1_grad[3, first : first + 2].tolist()}, not vertex {first}"
                )
        for vert, first in ((100, pc - 1), (300, pc + group - 1), (200, 2000)):
            l2_tie = tie.l2_grad[2, vert].tolist()
            if abs(l2_tie[0] + 0.6) > 1e-6 or abs(l2_tie[1] + 0.8) > 1e-6:
                raise AssertionError(f"{tag}: the pixel tie on vertex {vert} gave {l2_tie}, not pixel {first}'s")
        if with_value:
            value, grad = cc.chamfer_value_and_grad(gt, mask, pred, f32_index=f32_index)
            bad = (value - ref_value).abs() > 1e-5 * ref_value.abs()
            if bool(bad.any()) or float(value[5]) != 0.0:
                raise AssertionError(f"{tag}: value {value.tolist()} vs plain {ref_value.tolist()}")
            if float(grad[5].abs().max()) != 0.0:
                raise AssertionError(f"{tag}: an empty mask has a nonzero gradient")
            max_err = max(float((value - ref_value).abs().max()), float((grad - ref_grad).abs().max()))
            fn = lambda f=f32_index: cc.chamfer_value_and_grad(gt, mask, pred, f32_index=f)
            plain = lambda: cc.chamfer_value_and_grad_reference(gt, mask, pred)
            out_bytes = n * 4 + pred.numel() * 4
            in_extra = 0
        else:
            grad = cc.chamfer_grad(gt, mask, pred, ct)
            max_err = float((grad - ref_k3).abs().max())
            fn = lambda: cc.chamfer_grad(gt, mask, pred, ct)
            plain = lambda: cc.chamfer_grad_reference(gt, mask, pred, ct)
            out_bytes = pred.numel() * 4
            in_extra = n * 4  # the cotangent
        ms = _time_cuda(fn, iters=100)
        device_ms = _time_cuda(fn, iters=100, queued=True)
        plain_ms = _time_cuda(plain, iters=3, warmup=1)
        library_ms = _pred_to_gt_library_ms(torch, cc, gt, mask, pred, iters=20, with_indices=True)
        bound_ms, bound_by = _bound(torch, cc, gt, mask, pred, out_bytes, in_extra)
        lines.append(
            f"{tag} {name}: max_abs_err={max_err:.3e} l2_err={l2_err:.3e} ms={ms:.4f} (back to back) "
            f"device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
            f"cdist_min_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "human_pose_estimation_tpu_torch/csrc/chamfer_bwd.cu",
            "replaces": replaces,
            "max_abs_err": max_err,
            "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    split = _per_launch_ms(torch, lambda: cc.chamfer_value_and_grad(gt, mask, pred), 20, K2_KERNELS)
    splits = ", ".join(f"{k} {split[k][0]:.4f} ms x{split[k][1]}" for k in K2_KERNELS if k in split)
    warps = cc.bwd_resident_warps()
    print(
        f"[kernel] chamfer_bwd N={n} P={gt.shape[1]} V={v} valid={int(mask.sum())}: L1 gradient exact, "
        f"vmin bit-equal, repeatable, tie on vertex 0, chunk-straddling ties on vertex {vc - 1} and pixel "
        f"{pc - 1}, group-straddling ties on vertex {vc + group - 1} and pixel {pc + group - 1}, pixel tie "
        f"inside a group on pixel 2000, empty mask 0, value rtol 1e-5 | " + " | ".join(lines) + f" | K2 per launch over 20 calls "
        f"(profiler): {splits or 'not measured (the profiler saw no CUDA kernel)'} | tiling {tiling}, "
        f"resident warps per SM {warps} | on {card}",
        flush=True,
    )
    return entries


def _seeded_hmr(smpl, encoder_dtype, device, seed=0):
    from human_pose_estimation_tpu_torch.models.hmr import HMR

    return HMR(smpl, encoder_dtype=encoder_dtype, device=device, seed=seed)


def phase_serving(torch, card, smpl, mean_theta):
    """The serving path: Predictor at full width (ResNet-50, 224 px, bf16
    encoder, 6890 vertices, batch 64) on uint8 requests."""
    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor

    batch, img = 64, 224
    cfg = Config(batch_size=batch, img_size=img, encoder_dtype="bfloat16")
    variables = _seeded_hmr(smpl, "bfloat16", "cuda").state_dict()
    pred = Predictor(cfg, smpl=smpl, variables=variables, mean_theta=mean_theta)
    rng = np.random.RandomState(0)
    requests = rng.randint(0, 256, size=(5 * batch + 37, img, img, 3)).astype("uint8")

    pred.predict(requests[:batch])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):  # each: 5 batches, all enqueued before the first fetch
        t0 = time.perf_counter()
        full = pred.predict(requests[: 5 * batch])
        runs.append(time.perf_counter() - t0)
    secs = float(np.median(runs))
    partial = pred.predict(requests[5 * batch :])  # 37 rows, padded to 64
    v = smpl.num_verts
    for out, n in ((full, 5 * batch), (partial, 37)):
        shapes = {k: a.shape for k, a in out.items()}
        want = {
            "generated_verts": (n, v, 3), "generated_cams": (n, 3), "generated_joints": (n, 14, 3),
            "theta": (n, 85), "kp2d": (n, 14, 2),
        }
        if shapes != want:
            raise AssertionError(f"serving output shapes {shapes} != {want}")
        for k, a in out.items():
            if not np.isfinite(a).all():
                raise AssertionError(f"serving output {k} is not finite")
    single = pred.predict_single_image(requests[5 * batch])
    if abs(single[0] - partial["generated_verts"][:1]).max() > 2e-2:
        raise AssertionError("predict_single_image disagrees with the padded batch")

    # the card against the CPU on a small input: the same f32 model
    small = torch.from_numpy(requests[:2]).float() / 127.5 - 1.0
    gpu = _seeded_hmr(smpl, "float32", "cuda", seed=1)
    cpu = _seeded_hmr(smpl, "float32", "cpu", seed=1)
    with torch.inference_mode():
        a = gpu(small.cuda(), mean_theta.cuda(), smpl_stages="last")[-1].verts.cpu()
        b = cpu(small, mean_theta, smpl_stages="last")[-1].verts
    rel = float((a - b).abs().max() / b.abs().max())
    if not rel <= 1e-3:
        raise AssertionError(f"f32 HMR on the card differs from the CPU by {rel:.2e} (max relative)")
    ips = 5 * batch / secs
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as flops:
        pred.hmr(small.cuda()[:1], mean_theta.cuda(), smpl_stages="last")
    tflops = flops.get_total_flops() * ips / 1e12  # matmul/conv flops, 2 per multiply-add
    breakdown = _device_breakdown(torch, lambda: pred.predict(requests[:batch]), secs * 1e3 / 5)
    print(
        f"[serving] Predictor ResNet-50 224px bf16 batch {batch}: {ips:.1f} img/s median of "
        f"{len(runs)} runs (min {5 * batch / max(runs):.1f}, max {5 * batch / min(runs):.1f}; "
        f"each {5 * batch} uint8 images to numpy outputs, {secs * 1e3:.1f} ms), "
        f"{flops.get_total_flops() / 1e9:.2f} GFLOP/image so {tflops:.1f} TFLOP/s, "
        f"partial batch of 37 ok, f32 card-vs-CPU max rel {rel:.2e} | one batch: {breakdown} "
        f"| on {card}",
        flush=True,
    )
    return ips


def _eval_batches(torch, gen, n, p, img, count):
    """``count`` evaluation GenBatches on the card: silhouettes of 2k-9k
    pixels (mean ~4.5k: one large, the rest 2k-6.2k), keypoints, images."""
    from human_pose_estimation_tpu_torch.train.step import GenBatch

    batches = []
    for _ in range(count):
        counts = torch.randint(2000, 6200, (n,), generator=gen).tolist()
        counts[0] = int(torch.randint(6200, 9200, (1,), generator=gen))
        pts, mask = _eval_silhouettes(gen, n, p, counts, img)
        kp = torch.rand(n, 19, 3, generator=gen) * 2 - 1
        kp[..., 2] = (torch.rand(n, 19, generator=gen) > 0.2).float()
        images = torch.rand(n, img, img, 3, generator=gen) * 2 - 1
        batches.append(GenBatch(images.cuda(), pts.cuda(), mask.cuda(), kp.cuda()))
    return batches


def phase_eval(torch, cc, card, smpl, mean_theta, num_batches=10):
    """The evaluation path: make_val_step at full width (batch 8, P=16384
    silhouette budget, mesh loss on all three IEF stages), aggregated as
    the validation sweep does."""
    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.core.projection import reproject_to_pixels
    from human_pose_estimation_tpu_torch.models.critic import Critic
    from human_pose_estimation_tpu_torch.ops.losses import mesh_reprojection_loss
    from human_pose_estimation_tpu_torch.ops.metrics import pck, pck_auc, pck_curve
    from human_pose_estimation_tpu_torch.train.step import make_val_step

    n, img, p = 8, 224, 16384
    cfg = Config(
        batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
        mr_metric_stages="all", max_silhouette_points=p,
    )
    hmr = _seeded_hmr(smpl, "bfloat16", "cuda")
    gen = torch.Generator().manual_seed(1)
    critic = Critic()
    critic.reset_parameters(gen)
    critic = critic.cuda().eval()
    val_step = make_val_step(hmr, critic, cfg, return_stages=True)

    batches = _eval_batches(torch, gen, n, p, img, num_batches + 1)
    val_step(mean_theta.cuda(), batches[0])  # warm-up
    torch.cuda.synchronize()

    outs, times = [], []
    for batch in batches[1:]:
        before = cc.LAUNCHES
        t0 = time.perf_counter()
        out = val_step(mean_theta.cuda(), batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if cc.LAUNCHES - before != 3:
            raise AssertionError(f"eval batch launched K1 {cc.LAUNCHES - before} times, not 3")
        outs.append(out)

    kprs, mrs, pcks, gts, preds = [], [], [], [], []
    for batch, out in zip(batches[1:], outs):
        ref = torch.stack([
            cfg.mr_loss_weight * mesh_reprojection_loss(
                batch.seg_points, batch.seg_mask,
                reproject_to_pixels(out["stage_verts"][s], out["stage_cams"][s], float(img)),
                scale_mode=cfg.mr_scale_mode, impl="reference",
            )
            for s in range(3)
        ])
        mr = out["mr_losses"]
        if not bool(((mr - ref).abs() <= 1e-5 * ref.abs()).all()):
            raise AssertionError(f"mr_losses {mr.tolist()} differ from the plain version {ref.tolist()}")
        for k, t in out.items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"eval output {k} is not finite")
        k = out["pred_keypoints"].shape[1]
        kp_gt = batch.kp2d[:, :k]
        kprs.append(float(out["kpr_losses"][-1]))
        mrs.append(float(mr[-1]))
        pcks.append(float(pck(kp_gt, out["pred_keypoints"])))
        gts.append(kp_gt)
        preds.append(out["pred_keypoints"])
    gt_all, pred_all = torch.cat(gts), torch.cat(preds)
    curve = pck_curve(gt_all, pred_all).tolist()
    wall_ms = 1e3 * float(np.median(times))
    breakdown = _device_breakdown(torch, lambda: val_step(mean_theta.cuda(), batches[1]), wall_ms)
    calls = num_batches + 2  # warm-up, timed batches, profiled batch
    if cc.LAUNCHES != 3 * calls:
        raise AssertionError(f"K1 launched {cc.LAUNCHES} times in {calls} eval batches")
    print(
        f"[eval] make_val_step batch {n} P={p} mr on 3 stages, {num_batches} batches: "
        f"{wall_ms:.2f} ms/batch median (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
        f"K1 launches {cc.LAUNCHES} in {calls} batches (3 per batch), "
        f"mr vs plain rtol 1e-5 ok | mean kpr {np.mean(kprs):.5f} mean mr {np.mean(mrs):.6f} "
        f"PCK@0.5 {np.mean(pcks):.4f} curve {[round(c, 4) for c in curve]} "
        f"AUC {float(pck_auc(gt_all, pred_all)):.4f} | one batch: {breakdown} | on {card}",
        flush=True,
    )
    return wall_ms


def _train_batches(torch, smpl, n, p, img, count, seed, device):
    """``count`` (GenBatch, MocapBatch) pairs: images, silhouettes of
    2k-9k pixels (mean ~4.5k; capped at ``p``), keypoints, and 3n mocap
    samples posed by the port's body model from seeded poses and shapes."""
    from human_pose_estimation_tpu_torch.core.smpl import smpl_forward
    from human_pose_estimation_tpu_torch.train.step import GenBatch, MocapBatch

    gen = torch.Generator().manual_seed(seed)
    body = smpl.to(device)
    out = []
    for _ in range(count):
        counts = torch.randint(2000, 6200, (n,), generator=gen).clamp_max(p).tolist()
        counts[0] = min(p, int(torch.randint(6200, 9200, (1,), generator=gen)))
        pts, mask = _eval_silhouettes(gen, n, p, counts, img)
        kp = torch.rand(n, 19, 3, generator=gen) * 2 - 1
        kp[..., 2] = (torch.rand(n, 19, generator=gen) > 0.2).float()
        images = torch.rand(n, img, img, 3, generator=gen) * 2 - 1
        pose = torch.randn(3 * n, 72, generator=gen) * 0.2
        shape = torch.randn(3 * n, 10, generator=gen) * 0.4
        with torch.no_grad():
            mocap = smpl_forward(body, shape.to(device), pose.to(device), joint_type="cocoplus")
        out.append((
            GenBatch(images.to(device), pts.to(device), mask.to(device), kp.to(device)),
            MocapBatch(mocap.joints, shape.to(device), mocap.rotations[:, 1:]),
        ))
    return out


def _param_groups(state):
    return {
        "encoder": list(state.hmr.encoder.parameters()),
        "regressor": list(state.hmr.regressor.parameters()),
        "mean_theta": [state.mean_theta],
        "critic": list(state.critic.parameters()),
    }


def phase_train(torch, cc, card, smpl, mean_theta, num_steps=10):
    """The training path: make_train_step at full width (ResNet-50, 224 px,
    bf16 encoder, batch 8, P=16384 silhouettes of 2k-9k pixels, 6890
    vertices, mesh loss on all three IEF stages, gradient penalty on),
    one warm-up step and ``num_steps`` timed steps."""
    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.train.state import create_train_state
    from human_pose_estimation_tpu_torch.train.step import make_train_step

    n, img, p = 8, 224, 16384
    cfg = Config(
        batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
        mr_metric_stages="all", max_silhouette_points=p, use_gradient_penalty=True,
    )
    state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    step = make_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = _train_batches(torch, smpl, n, p, img, num_steps + 2, seed=2, device="cuda")
    start = {k: [t.detach().clone() for t in ts] for k, ts in _param_groups(state).items()}

    def run(batch, mocap):
        k1, k2 = cc.LAUNCHES, cc.VALUE_GRAD_LAUNCHES
        metrics = step(state, batch, mocap, gen)
        torch.cuda.synchronize()
        if cc.VALUE_GRAD_LAUNCHES - k2 != 3 or cc.LAUNCHES != k1:
            raise AssertionError(
                f"a training step launched K2 {cc.VALUE_GRAD_LAUNCHES - k2} times (not 3) "
                f"and K1 {cc.LAUNCHES - k1} times (not 0)"
            )
        return metrics

    torch.cuda.reset_peak_memory_stats()  # the peak of this phase, not of the run so far
    run(*batches[0])  # warm-up: cuDNN plans, allocator
    times, metrics = [], []
    for batch, mocap in batches[1 : num_steps + 1]:
        t0 = time.perf_counter()
        metrics.append(run(batch, mocap))
        times.append(time.perf_counter() - t0)
    for m in metrics:
        for field, value in vars(m).items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"training metric {field} is not finite: {value}")
    for k, ts in _param_groups(state).items():
        if not any(bool((a != b).any()) for a, b in zip(ts, start[k])):
            raise AssertionError(f"training never moved the {k} parameters")
    wall_ms = 1e3 * float(np.median(times))
    breakdown = _device_breakdown(torch, lambda: run(*batches[-1]), wall_ms, "K2", K2_KERNELS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    first, last = metrics[0], metrics[-1]
    print(
        f"[train] make_train_step ResNet-50 {img}px bf16 batch {n} P={p} mr on 3 stages, GP on, mocap {3 * n}: "
        f"{wall_ms:.2f} ms/step median of {num_steps} (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
        f"K2 launches 3 per step, K1 0, losses finite, all 4 parameter groups moved | "
        f"step 1 -> {num_steps}: generator_loss {float(first.generator_loss):.4f} -> {float(last.generator_loss):.4f}, "
        f"critic_loss {float(first.critic_loss):.4f} -> {float(last.critic_loss):.4f}, "
        f"mr[-1] {float(first.mr_losses[-1]):.5f} -> {float(last.mr_losses[-1]):.5f} | "
        f"peak memory {peak_gib:.2f} GiB | one step: {breakdown} | on {card}",
        flush=True,
    )
    return wall_ms


def _parity_step(torch, smpl, mean_theta, cfg, batch, mocap, device, dtype):
    """One make_train_step from the seeded state in ``dtype`` on ``device``
    with dropout rate 0, the GP uniforms of the global batch from a fixed
    CPU generator, and SGD with rate 1 (so that before - after is the
    gradient): (metrics, gradients, the HMR's BN statistics), on the CPU in
    f64. Under a process group ``batch`` and ``mocap`` are this rank's rows."""
    from torch.optim.lr_scheduler import LambdaLR

    from human_pose_estimation_tpu_torch.train import step as tstep
    from human_pose_estimation_tpu_torch.train.state import create_train_state

    def uniforms(fake_joints, fake_shapes, fake_rs, generator):
        g = torch.Generator().manual_seed(7)
        return [torch.rand(t.shape, generator=g).to(t.device, t.dtype) for t in (fake_joints, fake_shapes, fake_rs)]

    state = create_train_state(smpl.to("cpu", dtype), mean_theta, cfg, device=device, seed=1)
    state.hmr.to(dtype)
    state.critic.to(dtype)
    state.mean_theta.data = state.mean_theta.data.to(dtype)
    state.hmr.regressor.dropout_rate = 0.0
    state.gen_opt = torch.optim.SGD(state.gen_params(), lr=1.0)
    state.critic_opt = torch.optim.SGD(list(state.critic.parameters()), lr=1.0)
    state.gen_sched = LambdaLR(state.gen_opt, lambda count: 1.0)
    state.critic_sched = LambdaLR(state.critic_opt, lambda count: 1.0)
    params = {f"{k}.{i}": t for k, ts in _param_groups(state).items() for i, t in enumerate(ts)}
    before = {k: t.detach().clone() for k, t in params.items()}
    to = lambda b: type(b)(*(t.to(device, dtype) for t in b))
    drawn = tstep._gp_uniforms
    tstep._gp_uniforms = uniforms
    try:
        metrics = tstep.make_train_step(cfg, device=device)(
            state, to(batch), to(mocap), torch.Generator(device=device).manual_seed(0)
        )
    finally:
        tstep._gp_uniforms = drawn
    grads = {k: (before[k] - t.detach()).cpu().double() for k, t in params.items()}
    stats = {k: v.cpu().double() for k, v in state.hmr.state_dict().items() if k.endswith(("_mean", "_var"))}
    return {f: v.cpu().double() for f, v in vars(metrics).items()}, grads, stats


def _worst(out, ref):
    """(StepMetrics max error relative to each field's largest magnitude,
    gradient max error relative to each tensor's largest magnitude, with a
    floor of 1e-5 of the largest gradient of all: the conv biases before a
    BN have an exact zero gradient, of which both sides hold only rounding)."""
    (m_out, g_out), (m_ref, g_ref) = out[:2], ref[:2]
    worst_m = max(float((m_out[f] - r).abs().max()) / max(float(r.abs().max()), 1e-30) for f, r in m_ref.items())
    scale = max(float(g.abs().max()) for g in g_ref.values())
    worst_g, leaf = max(
        (float((g_out[k] - r).abs().max()) / max(float(r.abs().max()), 1e-5 * scale), k) for k, r in g_ref.items()
    )
    return worst_m, worst_g, leaf


def phase_train_parity(torch, card, smpl, mean_theta):
    """The card against the CPU: one make_train_step in f64 from the same
    seeded weights (dropout rate 0, the same GP uniforms, SGD with rate 1
    so that before - after is the gradient, the penalty's double backward
    included), ResNet-50 at 224 px, batch 2, a P=2048 silhouette budget;
    the card runs K2, the CPU its plain version. StepMetrics and gradients
    within 1e-5 of each field's / tensor's largest magnitude. The step is
    compared in f64 because in f32 it is ill-conditioned on either device:
    the same f32 step on the card is also run, and its distance from the
    f64 step is printed (not checked)."""
    from human_pose_estimation_tpu_torch.config import Config

    n, img, p = 2, 224, 2048
    cfg = Config(batch_size=n, img_size=img, encoder_dtype="float32", use_mesh_repro_loss=True)
    (batch, mocap), = _train_batches(torch, smpl, n, p, img, 1, seed=3, device="cpu")
    f64, f32 = torch.float64, torch.float32
    cpu64 = _parity_step(torch, smpl, mean_theta, cfg, batch, mocap, "cpu", f64)
    gpu64 = _parity_step(torch, smpl, mean_theta, cfg, batch, mocap, "cuda", f64)
    gpu32 = _parity_step(torch, smpl, mean_theta, cfg, batch, mocap, "cuda", f32)
    worst_m, worst_g, leaf = _worst(gpu64, cpu64)
    if not (worst_m <= 1e-5 and worst_g <= 1e-5):
        raise AssertionError(
            f"f64 train step, card vs CPU: StepMetrics {worst_m:.2e}, gradients {worst_g:.2e} ({leaf}); limit 1e-5"
        )
    m32, g32, leaf32 = _worst(gpu32, cpu64)
    print(
        f"[train-parity] make_train_step ResNet-50 {img}px batch {n} P={p}, f64, card (K2) vs CPU (plain "
        f"version): StepMetrics max rel {worst_m:.2e}, gradients max rel {worst_g:.2e} ({leaf}); limit 1e-5 | "
        f"the f32 step on the card vs the f64 step: StepMetrics {m32:.2e}, gradients {g32:.2e} ({leaf32}) | on {card}",
        flush=True,
    )


# a standing figure around (0, 0) in units of its size factor: (centre x,
# centre y, half width, half height) of the head (an ellipse, first), the
# torso (an ellipse), the legs and the arms (rectangles); about 4.1k pixels
# at factor 1
_FIGURE_ELLIPSES = ((0, -62, 10, 10), (0, -15, 15, 36))
_FIGURE_BOXES = ((-8, 42, 5, 28), (8, 42, 5, 28), (-22, -20, 5, 25), (22, -20, 5, 25))
# the 19 cocoplus keypoints on that figure (LSP 14, then nose, eyes, ears)
_FIGURE_JOINTS = (
    (-8, 68), (-8, 42), (-8, 15), (8, 15), (8, 42), (8, 68), (-22, 3), (-22, -20), (-18, -45),
    (18, -45), (22, -20), (22, 3), (0, -50), (0, -72), (0, -62), (3, -65), (-3, -65), (7, -62), (-7, -62),
)


def _host_batches(torch, count, n=8, canvas=256, seed=4):
    """``count`` HostBatches of ``n`` uint8 ``canvas``-square canvases in
    pinned memory, as the host pipelines hand them over: random RGB inside
    a true extent of 200-256 per side, a filled figure in the seg (about
    3.3k-5.4k pixels, so 2k-9k after a crop at scale 0.8-1.23), its centre
    near the figure's, and 19 keypoints on it in (3, 19) layout."""
    import numpy as np

    from human_pose_estimation_tpu_torch.train.step import HostBatch

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:canvas, :canvas]
    out = []
    for _ in range(count):
        image = rng.randint(0, 256, (n, canvas, canvas, 3)).astype(np.uint8)
        seg = np.zeros((n, canvas, canvas, 1), np.uint8)
        hw = rng.randint(200, canvas + 1, (n, 2)).astype(np.int32)
        center = np.zeros((n, 2), np.int32)
        label = np.zeros((n, 3, 19), np.float32)
        for b, (h, w) in enumerate(hw):
            image[b, h:] = 0
            image[b, :, w:] = 0
            cx, cy = w // 2 + rng.randint(-10, 11), h // 2 + rng.randint(-10, 11)
            k = rng.uniform(0.9, 1.15)
            fig = np.zeros((canvas, canvas), bool)
            for ex, ey, ax, ay in _FIGURE_ELLIPSES:
                fig |= ((xx - cx - k * ex) / (k * ax)) ** 2 + ((yy - cy - k * ey) / (k * ay)) ** 2 < 1.0
            for bx, by, ax, ay in _FIGURE_BOXES:
                fig |= (np.abs(xx - cx - k * bx) < k * ax) & (np.abs(yy - cy - k * by) < k * ay)
            seg[b, ..., 0] = 255 * fig
            center[b] = cx, cy
            joints = np.asarray(_FIGURE_JOINTS, np.float32)
            label[b, 0] = cx + k * joints[:, 0] + rng.randn(19)
            label[b, 1] = cy + k * joints[:, 1] + rng.randn(19)
            label[b, 2] = rng.rand(19) > 0.1
        out.append(HostBatch(*(torch.from_numpy(a).pin_memory() for a in (image, seg, hw, center, label))))
    return out


def _mocap_stream(torch, cfg, smpl, samples, seed=5):
    """The raw (pose, shape) stream of NpzMocapPipeline (device_forward
    off, on the card) over a seeded shard written under build/."""
    import numpy as np

    from human_pose_estimation_tpu_torch.data.npz_dataset import NpzMocapPipeline, write_mocap_npz_shard

    rng = np.random.RandomState(seed)
    path = MOCAP_SHARD
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_mocap_npz_shard(path, rng.randn(samples, 72) * 0.2, rng.randn(samples, 10) * 0.4)
    return iter(NpzMocapPipeline(cfg, smpl, [path], device_forward=False, device="cuda"))


def _fused_cfg(**kw):
    from human_pose_estimation_tpu_torch.config import Config

    return Config(
        batch_size=8, img_size=224, encoder_dtype="bfloat16", use_mesh_repro_loss=True, mr_metric_stages="all",
        max_silhouette_points=16384, use_gradient_penalty=True, fuse_preprocess=True, **kw,
    )


def _counted_step(torch, cc, fused):
    """``fused`` with its chamfer launches checked: 3 of K2 and none of K1
    per step."""

    def run(state, host, raw, gen):
        k1, k2 = cc.LAUNCHES, cc.VALUE_GRAD_LAUNCHES
        metrics = fused(state, host, raw, gen)
        torch.cuda.synchronize()
        if cc.VALUE_GRAD_LAUNCHES - k2 != 3 or cc.LAUNCHES != k1:
            raise AssertionError(
                f"a fused step launched K2 {cc.VALUE_GRAD_LAUNCHES - k2} times (not 3) "
                f"and K1 {cc.LAUNCHES - k1} times (not 0)"
            )
        return metrics

    return run


def phase_fused_train(torch, cc, card, smpl, mean_theta, hosts, raws, num_steps=10):
    """The fused training path: make_fused_train_step at full width
    (ResNet-50, 224 px, bf16 encoder, batch 8, augmentation on, P=16384,
    mesh loss on all three IEF stages, gradient penalty on) from pinned
    uint8 canvases and raw mocap; one warm-up step and ``num_steps`` timed
    steps."""
    import numpy as np

    from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor
    from human_pose_estimation_tpu_torch.train.state import create_train_state
    from human_pose_estimation_tpu_torch.train.step import make_fused_train_step

    cfg = _fused_cfg()
    state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    run = _counted_step(torch, cc, make_fused_train_step(cfg, smpl, augment=True, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = {k: [t.detach().clone() for t in ts] for k, ts in _param_groups(state).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    k2_before = cc.VALUE_GRAD_LAUNCHES
    run(state, hosts[0], raws[0], gen)  # warm-up: cuDNN plans, allocator
    times, metrics, draws = [], [], []
    for host, raw in zip(hosts[1 : num_steps + 1], raws[1 : num_steps + 1]):
        draws.append(gen.get_state())  # the augmentation draws first
        t0 = time.perf_counter()
        metrics.append(run(state, host, raw, gen))
        times.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for m in metrics:
        for field, value in vars(m).items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"fused training metric {field} is not finite: {value}")
    for k, ts in _param_groups(state).items():
        if not any(bool((a != b).any()) for a, b in zip(ts, start[k])):
            raise AssertionError(f"fused training never moved the {k} parameters")

    # the silhouettes the timed steps trained on: their draws replayed
    prep = DevicePreprocessor(cfg, augment=True, device="cuda")
    counts = []
    for host, drawn in zip(hosts[1:], draws):
        replay = torch.Generator(device="cuda")
        replay.set_state(drawn)
        counts += prep(host._asdict(), replay).seg_mask.sum(dim=1).tolist()
    if min(counts) < 1000:
        raise AssertionError(f"a training silhouette has {min(counts)} pixels")
    prep_gen = torch.Generator(device="cuda").manual_seed(1)
    prep_ms, prep_launches = _profiled_device_ms(torch, lambda: prep(hosts[1]._asdict(), prep_gen))
    syncs = _host_syncs(torch, lambda: run(state, hosts[-1], raws[-1], gen))

    wall_ms = 1e3 * float(np.median(times))
    breakdown = _device_breakdown(
        torch, lambda: run(state, hosts[-1], raws[-1], gen), wall_ms, "K2", K2_KERNELS, span="step.prep"
    )
    steps = num_steps + 3  # the warm-up, the timed steps, the profiled step and the step of the sync count
    if cc.VALUE_GRAD_LAUNCHES - k2_before != 3 * steps:
        raise AssertionError(f"{steps} fused steps launched K2 {cc.VALUE_GRAD_LAUNCHES - k2_before} times")
    first, last = metrics[0], metrics[-1]
    print(
        f"[fused-train] make_fused_train_step ResNet-50 224px bf16 batch 8 from pinned uint8 256x256 canvases, "
        f"augmentation on, P=16384 mr on 3 stages, GP on, mocap 24 raw from NpzMocapPipeline: "
        f"{wall_ms:.2f} ms/step median of {num_steps} (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
        f"K2 launches 3 per step, K1 0, losses finite, all 4 parameter groups moved | silhouettes "
        f"{int(min(counts))}/{np.mean(counts):.0f}/{int(max(counts))} pixels (min/mean/max of {len(counts)}) | "
        f"step 1 -> {num_steps}: generator_loss {float(first.generator_loss):.4f} -> "
        f"{float(last.generator_loss):.4f}, mr[-1] {float(first.mr_losses[-1]):.5f} -> "
        f"{float(last.mr_losses[-1]):.5f} | peak memory {peak_gib:.2f} GiB | DevicePreprocessor alone "
        f"(copy, augmentation, silhouettes) {prep_ms:.3f} ms of device time in {prep_launches:.0f} launches "
        f"per call (profiler, 5 calls) | host syncs in one step: {syncs} (sync debug mode) | one step: "
        f"{breakdown} | on {card}",
        flush=True,
    )
    return wall_ms


def phase_augment_parity(torch, card, host):
    """augment_batch + extract_silhouette on the card against the same
    functions on the CPU, full 256x256 canvases to 224 px crops with pinned
    draws (flip on and off, scales 0.8 / 1.0 / 1.23, non-zero trans), f32:
    crops, seg crops and labels within atol 1e-5, silhouette points and
    masks equal element by element (order included) at P=16384 and at a
    truncating P=1024."""
    from human_pose_estimation_tpu_torch.data.augment import AugmentConfig, augment_batch, extract_silhouette

    n = host.image.shape[0]
    cfg = AugmentConfig(out_size=224)
    overrides = (
        torch.tensor([[7, -5], [-13, 11], [19, 3], [-20, -20], [1, 17], [-6, 2], [12, -9], [-3, 14]])[:n],
        torch.tensor([0.8, 1.0, 1.23, 0.8, 1.0, 1.23, 0.91, 1.12])[:n],
        torch.arange(n) % 2 == 1,
    )

    def run(dev):
        args = [t.to(dev) for t in host]
        crops, segs, labels = augment_batch(*args, None, cfg, overrides=tuple(o.to(dev) for o in overrides))
        out = [crops, segs, labels, *extract_silhouette(segs, 16384), *extract_silhouette(segs, 1024)]
        return [t.cpu() for t in out]

    card_out, cpu_out = run("cuda"), run("cpu")
    errs = {}
    for name, a, b in zip(("crops", "seg crops", "labels"), card_out[:3], cpu_out[:3]):
        errs[name] = float((a - b).abs().max())
        if not errs[name] <= 1e-5:
            raise AssertionError(f"{name} on the card differ from the CPU by {errs[name]:.3e} (atol 1e-5)")
    for name, a, b in zip(("points", "mask", "points at P=1024", "mask at P=1024"), card_out[3:], cpu_out[3:]):
        if not torch.equal(a, b):
            raise AssertionError(f"silhouette {name} on the card differ from the CPU")
    counts = card_out[4].sum(dim=1)
    if int(counts.min()) <= 1024:
        raise AssertionError(f"a silhouette of {int(counts.min())} pixels does not exercise the truncation")
    print(
        f"[augment-parity] augment_batch + extract_silhouette, {n} canvases 256x256 -> 224, scales "
        f"{overrides[1].tolist()}, flips {overrides[2].int().tolist()}, card vs CPU (f32): max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (atol 1e-5); silhouettes of {counts.int().tolist()} pixels equal element by element, order "
        f"included, at P=16384 and truncated at P=1024 | on {card}",
        flush=True,
    )


def _close_losses(got, ref, rtol, what):
    """The per-step losses of two runs ({field: CPU tensor}): kpr_losses
    and generator_loss within ``rtol``, critic_loss within ``rtol`` and
    atol 1e-4 (it can be near zero), as the JAX package's multi-step test
    holds them."""
    for field, atol in (("kpr_losses", 0.0), ("generator_loss", 0.0), ("critic_loss", 1e-4)):
        a, b = got[field].double(), ref[field].double()
        if not bool(((a - b).abs() <= rtol * b.abs() + atol).all()):
            raise AssertionError(f"{what}: {field} {a.tolist()} vs {b.tolist()} (rtol {rtol}, atol {atol})")


def phase_multi_step(torch, cc, card, smpl, mean_theta, hosts, raws, k=4):
    """make_multi_step(fused, k) against k sequential fused calls, from two
    states made from one seed and two generators seeded alike: the first
    step's losses within rtol 1e-5 (the same inputs), the later ones within
    5e-3 (cuDNN's backward is not bitwise deterministic, and Adam carries
    the difference on)."""
    from human_pose_estimation_tpu_torch.train.state import create_train_state
    from human_pose_estimation_tpu_torch.train.step import make_fused_train_step, make_multi_step

    cfg = _fused_cfg()
    fused = make_fused_train_step(cfg, smpl, augment=True, device="cuda")
    run = _counted_step(torch, cc, fused)
    seq_state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    multi_state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    seq = [run(seq_state, h, r, gen) for h, r in zip(hosts[:k], raws[:k])]
    seq_ms = 1e3 * (time.perf_counter() - t0) / k
    before = cc.VALUE_GRAD_LAUNCHES
    t0 = time.perf_counter()
    stacked = make_multi_step(fused, k)(multi_state, hosts[:k], raws[:k], torch.Generator(device="cuda").manual_seed(5))
    stacked = {f: v.cpu() for f, v in vars(stacked).items()}  # read once, after the k steps
    multi_ms = 1e3 * (time.perf_counter() - t0) / k
    if cc.VALUE_GRAD_LAUNCHES - before != 3 * k or multi_state.step != seq_state.step:
        raise AssertionError("make_multi_step did not run the k steps")
    rel = []
    for j, m in enumerate(seq):
        ref = {f: v.cpu() for f, v in vars(m).items()}
        got = {f: v[j] for f, v in stacked.items()}
        _close_losses(got, ref, 1e-5 if j == 0 else 5e-3, f"multi-step, step {j + 1}")
        rel.append(abs(float(got["generator_loss"] - ref["generator_loss"])) / abs(float(ref["generator_loss"])))
    print(
        f"[multi-step] make_multi_step(fused, {k}) vs {k} sequential fused steps, ResNet-50 224px bf16 batch 8: "
        f"losses of step 1 within rtol 1e-5, steps 2-{k} within 5e-3 (generator_loss rel "
        f"{', '.join(f'{r:.1e}' for r in rel)}) | {multi_ms:.2f} ms/step multi, {seq_ms:.2f} ms/step sequential "
        f"(each from a fresh state, first step included) | on {card}",
        flush=True,
    )


def phase_remat(torch, cc, card, smpl, mean_theta, hosts, raws, timed=3):
    """One fused step with remat_encoder on against off, from states made
    from one seed and generators seeded alike: StepMetrics within rtol 1e-5
    of each field's largest magnitude, the BN running statistics within
    1e-6 (a second update in the recompute would move each by 1% of its
    distance from the batch statistics); then ``timed`` more steps each for
    the times."""
    import numpy as np

    from human_pose_estimation_tpu_torch.train.state import create_train_state
    from human_pose_estimation_tpu_torch.train.step import make_fused_train_step

    res = {}
    for remat in (False, True):
        cfg = _fused_cfg(remat_encoder=remat)
        state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
        run = _counted_step(torch, cc, make_fused_train_step(cfg, smpl, augment=True, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(9)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        metrics = run(state, hosts[0], raws[0], gen)
        peak = torch.cuda.max_memory_allocated()
        stats = {k: v.clone() for k, v in state.hmr.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        metrics = {f: v.clone() for f, v in vars(metrics).items()}
        times = []
        for h, r in zip(hosts[1 : 1 + timed], raws[1 : 1 + timed]):
            t0 = time.perf_counter()
            run(state, h, r, gen)
            times.append(time.perf_counter() - t0)
        res[remat] = (metrics, stats, peak, peak - base, 1e3 * float(np.median(times)))
        del state
    (m0, s0, peak0, above0, ms0), (m1, s1, peak1, above1, ms1) = res[False], res[True]
    worst_m = max(float((m1[f] - v).abs().max()) / max(float(v.abs().max()), 1e-30) for f, v in m0.items())
    worst_s = max(float((s1[k] - v).abs().max()) for k, v in s0.items())
    if not (worst_m <= 1e-5 and worst_s <= 1e-6):
        raise AssertionError(f"remat vs plain: StepMetrics {worst_m:.2e} (rtol 1e-5), BN statistics {worst_s:.2e} (1e-6)")
    gib = 2**30
    print(
        f"[remat] fused step ResNet-50 224px bf16 batch 8, remat_encoder on vs off: StepMetrics max rel "
        f"{worst_m:.2e} (1e-5), BN running statistics max abs {worst_s:.2e} (1e-6: updated once) | peak memory "
        f"{peak1 / gib:.2f} GiB on vs {peak0 / gib:.2f} GiB off ({above1 / gib:.2f} vs {above0 / gib:.2f} GiB above "
        f"the state before the step) | {ms1:.2f} ms/step on vs {ms0:.2f} off (median of {timed}) | on {card}",
        flush=True,
    )


class _Resumable:
    """A stream over ``items`` that starts where ``{"pos": i}`` says: the
    image stream of the ``[trainer]`` phase, with the state a checkpoint
    keeps."""

    def __init__(self, items, n_valid):
        self.items, self.n_valid, self.pos = items, n_valid, 0

    def get_state(self):
        return {"pos": self.pos}

    def set_state(self, state):
        self.pos = int(state["pos"])

    def __iter__(self):
        while True:
            item = self.items[self.pos % len(self.items)]
            self.pos += 1
            yield item, self.n_valid


def _state_tensors(state):
    """Every float tensor of a TrainState's state_dict, by dotted name."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif hasattr(node, "is_floating_point") and node.is_floating_point():
            out[path] = node

    walk(state.state_dict(), "")
    return out


def _max_rel(torch, got, want):
    """(largest relative difference, its name) of two {name: tensor}: each
    tensor's largest difference over its own largest magnitude."""
    return max(
        (float((got[k].double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-30), k)
        for k, w in want.items()
    )


def phase_trainer(torch, cc, card, smpl, mean_theta, train_ms):
    """The ``[trainer]`` phase (``_phase_trainer``) with the loop's own
    progress and epoch lines kept off the output: one line per phase."""
    import contextlib
    import io

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        line = _phase_trainer(torch, cc, card, smpl, mean_theta, train_ms)
    print(line, flush=True)


def _phase_trainer(torch, cc, card, smpl, mean_theta, train_ms):
    """The training loop at full width: Trainer over ResNet-50 224 px bf16,
    batch 8, P=16384, mesh loss on 3 stages, GP on, mocap 24 from
    NpzMocapPipeline, 3 steps per epoch, a checkpoint every epoch and
    validation every 3 steps. A straight run of 6 steps; the loop's ms per
    step against its own bare step, timed alternately on the same
    pre-posed batches, beside ``[train]``'s; host syncs per step at
    scalar_log_step 1 and 1000; one checkpoint's bytes and its save and
    restore seconds; the restore into a fresh Trainer bit-equal; 3 steps +
    checkpoint + a fresh Trainer + 3 steps against the straight run,
    bit-equal where a second straight run is; validate_checkpoint against
    a hand loop of make_val_step; a Predictor restored from the checkpoint
    against one built from the state."""
    import itertools
    import shutil

    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.data.npz_dataset import NpzMocapPipeline
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor
    from human_pose_estimation_tpu_torch.ops.metrics import pck, pck_auc, pck_curve, per_joint_pck
    from human_pose_estimation_tpu_torch.train.state import step_generator
    from human_pose_estimation_tpu_torch.train.step import make_val_step
    from human_pose_estimation_tpu_torch.train.trainer import Trainer
    from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt

    n, img, p = 8, 224, 16384
    root = os.path.join(SMOKE_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)  # a step at or below the latest on disk is not saved again
    base = dict(
        batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True, mr_metric_stages="all",
        max_silhouette_points=p, use_gradient_penalty=True, num_examples_override=3 * n, checkpoint_every_epochs=1,
        validation_step_size=3, log_img_step=0, epoch=1000, model_dir=None, scalar_log_step=1,
    )
    pairs = _train_batches(torch, smpl, n, p, img, 6, seed=6, device="cuda")
    images = [b for b, _ in pairs]
    val_batches = _eval_batches(torch, torch.Generator().manual_seed(8), n, p, img, 4)

    def trainer(name, **kw):
        cfg = Config(**{**base, "checkpoint_dir": os.path.join(root, name), **kw})
        mocap = NpzMocapPipeline(cfg, smpl, [MOCAP_SHARD], device_forward=True, seed=3, device="cuda")
        t = Trainer(cfg, dataset=_Resumable(images, n), mocap_dataset=mocap, val_dataset=_Resumable(val_batches, n),
                    smpl=smpl, device="cuda")
        t.metrics = []  # every step's StepMetrics, on the card
        inner = t.train_step
        t.train_step = lambda *a: t.metrics.append(inner(*a)) or t.metrics[-1]
        return t

    # -- the straight run, and a second one for the spread of the card ----
    k1, k2 = cc.LAUNCHES, cc.VALUE_GRAD_LAUNCHES
    straight = trainer("straight")
    straight.train(max_steps=6)
    torch.cuda.synchronize()
    if (cc.VALUE_GRAD_LAUNCHES - k2, cc.LAUNCHES - k1) != (18, 6):
        raise AssertionError(
            f"6 trainer steps launched K2 {cc.VALUE_GRAD_LAUNCHES - k2} times (not 18) and K1 "
            f"{cc.LAUNCHES - k1} times (not 6: validation at steps 3 and 6)"
        )
    step_ms = [ms for tag, step, ms in straight.writers["train"].history if tag == "perf/step_time_ms" and step > 1]
    straight_ms = float(np.median(step_ms))
    if ckpt.latest_step(straight.config.checkpoint_dir) != 6 or straight.state.step != 6:
        raise AssertionError("the straight run did not checkpoint step 6")
    for m in straight.metrics:
        for field, value in vars(m).items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"trainer metric {field} is not finite: {value}")
    again = trainer("again", checkpoint_every_epochs=1000)
    again.train(max_steps=6)

    # -- the loop against its bare step, alternately, on the same inputs:
    # mocap posed before both timers, no validation, no checkpoint; each
    # interval holds one step and its one host sync (the metric copy in the
    # loop, a synchronize around the bare step, as in [train])
    timed = trainer("alternate", use_validation=False, checkpoint_every_epochs=1000, num_examples_override=1000 * n)
    timed.mocap_dataset = itertools.cycle([m for _, m in pairs])
    timed.train(max_steps=1)  # the first step of a state allocates its optimizer state
    rounds = 6
    loop_times, bare_times = [], []
    for _ in range(rounds):
        history = timed.writers["train"].history
        logged = len(history)
        timed.train(max_steps=3)
        loop_times += [ms for tag, _, ms in history[logged:] if tag == "perf/step_time_ms"]
        for batch, posed in pairs[:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed.train_step(timed.state, batch, posed, step_generator(timed.config.seed + 1, timed.state.step, "cuda"))
            torch.cuda.synchronize()
            bare_times.append(1e3 * (time.perf_counter() - t0))
    if len(loop_times) != 3 * rounds:
        raise AssertionError(f"the timed loop logged {len(loop_times)} step times, not {3 * rounds}")
    loop_ms, bare_ms = float(np.median(loop_times)), float(np.median(bare_times))
    # what the loop adds on the device: kernels and their time per step
    loop_dev = _profiled_device_ms(torch, lambda: timed.train(max_steps=1), calls=3)
    bare_dev = _profiled_device_ms(
        torch,
        lambda: timed.train_step(
            timed.state, *pairs[0], step_generator(timed.config.seed + 1, timed.state.step, "cuda")
        ),
        calls=3,
    )

    # -- host syncs per step, no epoch end, no validation ------------------
    syncs = {}
    counter = trainer("syncs", use_validation=False, num_examples_override=1000 * n)
    counter.train(max_steps=1)  # the first step of a state allocates its optimizer state
    for cadence in (1, 1000):
        counter.config = counter.config.replace(scalar_log_step=cadence)
        syncs[cadence] = _host_syncs(torch, lambda: counter.train(max_steps=3)) / 3
    if syncs[1] > 1 or syncs[1000] != 0:
        raise AssertionError(f"host syncs per step: {syncs[1]} logging every step (at most 1), {syncs[1000]} not (0)")

    # -- one checkpoint: bytes, save and restore seconds, bit-equal restore
    timed_dir = os.path.join(root, "timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_train_state(timed_dir, straight.state, input_state={"image": straight.dataset.get_state()})
    save_s = time.perf_counter() - t0
    step_dir = os.path.join(straight.config.checkpoint_dir, "6")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    fresh = trainer("straight")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if fresh.restore() != 6:
        raise AssertionError("the fresh Trainer restored no step 6")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved, loaded = straight.state.state_dict(), fresh.state.state_dict()
    flat_saved, flat_loaded = _state_tensors(straight.state), _state_tensors(fresh.state)
    unequal = [k for k, v in flat_saved.items() if not torch.equal(v, flat_loaded[k])]
    int_fields = [(saved[k]["step"], loaded[k]["step"]) for k in ("gen_adam", "critic_adam")]
    if (
        unequal or set(flat_saved) != set(flat_loaded) or fresh.state.step != 6
        or any(a != b for a, b in int_fields)
        or fresh.dataset.get_state() != straight.dataset.get_state()
        or fresh.mocap_dataset.get_state() != straight.mocap_dataset.get_state()
    ):
        raise AssertionError(f"the restore is not bit-equal: {unequal[:5]} ...")

    # -- resume: 3 steps, checkpoint, a fresh Trainer, 3 more ------------
    split = trainer("split")
    split.train(max_steps=3)
    split.save()
    resumed = trainer("split", train_from_checkpoint=True)
    resumed.train(max_steps=6)
    if resumed.state.step != 6:
        raise AssertionError(f"the resumed run ended at step {resumed.state.step}")

    if (resumed.dataset.get_state(), resumed.mocap_dataset.get_state()) != (
        straight.dataset.get_state(), straight.mocap_dataset.get_state()
    ):
        raise AssertionError("the resumed run's input streams ended elsewhere than the straight run's")

    def final(t):
        """Step 6's StepMetrics and every float tensor of the state."""
        out = {f"metrics.{f}": v for f, v in vars(t.metrics[-1]).items()}
        out.update(_state_tensors(t.state))
        return out

    want = final(straight)
    spread_unequal = [k for k, v in final(again).items() if not torch.equal(v, want[k])]
    resume_unequal = [k for k, v in final(resumed).items() if not torch.equal(v, want[k])]
    if not spread_unequal:
        # the card repeats a straight run bit for bit, so a resume must too
        if resume_unequal:
            raise AssertionError(
                f"resume vs straight: {len(resume_unequal)} of {len(want)} tensors differ ({resume_unequal[:5]}), "
                "where two straight runs are bit-equal"
            )
        resume_note = f"bit-equal ({len(want)} tensors: step 6's StepMetrics, the state), as two straight runs are"
    else:
        spread, spread_at = _max_rel(torch, final(again), want)
        resume_diff, resume_at = _max_rel(torch, final(resumed), want)
        limit = max(10 * spread, 1e-3)
        if not resume_diff <= limit:
            raise AssertionError(
                f"resume vs straight: max rel {resume_diff:.3e} ({resume_at}) over the limit {limit:.3e} "
                f"(two straight runs: {spread:.3e}, {spread_at})"
            )
        resume_note = (
            f"max rel {resume_diff:.3e} ({resume_at}) per tensor, two straight runs {spread:.3e} ({spread_at}; "
            f"{len(spread_unequal)} tensors differ), limit {limit:.3e}"
        )

    # -- validate_checkpoint against a hand loop of make_val_step ---------
    fresh.val_dataset = [(b, n) for b in val_batches]
    k1 = cc.LAUNCHES
    results = fresh.validate_checkpoint(restore=False)
    if cc.LAUNCHES - k1 != 12:
        raise AssertionError(f"validate_checkpoint over 4 batches launched K1 {cc.LAUNCHES - k1} times, not 12")
    hand = make_val_step(fresh.state.hmr, fresh.state.critic, fresh.config)
    kprs, mrs, pcks, gts, preds = [], [], [], [], []
    for b in val_batches:
        out = hand(fresh.state.mean_theta, b)
        gt, pred = b.kp2d[:, : out["pred_keypoints"].shape[1]].cpu(), out["pred_keypoints"].cpu()
        kprs.append(float(out["kpr_losses"][-1]))
        mrs.append(float(out["mr_losses"][-1]))
        pcks.append(float(pck(gt, pred)))
        gts.append(gt)
        preds.append(pred)
    gt_all, pred_all = torch.cat(gts), torch.cat(preds)
    want = {"mean_kpr_loss": np.mean(kprs), "mean_mr_loss": np.mean(mrs), "pck@0.5": np.mean(pcks)}
    want.update({f"pck@{t}": v for t, v in zip((0.1, 0.2, 0.3, 0.4, 0.5), pck_curve(gt_all, pred_all).tolist())})
    want["pck_auc@0.5"] = float(pck_auc(gt_all, pred_all))
    want["per_joint_pck@0.5"] = [round(float(v), 4) for v in per_joint_pck(gt_all, pred_all).tolist()]
    if set(results) != set(want) or not all(
        np.allclose(results[k], want[k], rtol=1e-6, atol=0.0) for k in want
    ):
        raise AssertionError(f"validate_checkpoint {results} differs from the hand loop {want} (rtol 1e-6)")

    # -- Predictor restored from the checkpoint vs built from the state ---
    serve = Config(batch_size=64, img_size=img, encoder_dtype="bfloat16", checkpoint_dir=straight.config.checkpoint_dir)
    requests = np.random.RandomState(9).randint(0, 256, size=(64, img, img, 3)).astype("uint8")
    from_ckpt = Predictor(serve, smpl=smpl).predict(requests)
    from_state = Predictor(
        serve, smpl=smpl, variables=straight.state.hmr.state_dict(), mean_theta=straight.state.mean_theta.detach()
    ).predict(requests)
    if set(from_ckpt) != set(from_state) or not all(np.array_equal(from_ckpt[k], from_state[k]) for k in from_state):
        raise AssertionError("the Predictor restored from the checkpoint differs from the one built from the state")

    return (
        f"[trainer] Trainer ResNet-50 {img}px bf16 batch {n} P={p} mr on 3 stages, GP on, mocap 24 from "
        f"NpzMocapPipeline, 3 steps/epoch, checkpoint every epoch, validation every 3 steps | loop vs its bare step "
        f"alternately (pre-posed mocap, no validation or checkpoint; {rounds} rounds of 3 + 3): {loop_ms:.2f} vs "
        f"{bare_ms:.2f} ms/step, median of {3 * rounds} each (loop min {min(loop_times):.2f} max "
        f"{max(loop_times):.2f}; bare min {min(bare_times):.2f} max {max(bare_times):.2f}); device per step "
        f"(profiler, 3 steps each): loop {loop_dev[0]:.3f} ms in {loop_dev[1]:.0f} launches, bare {bare_dev[0]:.3f} "
        f"ms in {bare_dev[1]:.0f}; [train] {train_ms:.2f} | straight run with mocap "
        f"posed in the loop, a validation and a checkpoint in its intervals (not comparable): {straight_ms:.2f} "
        f"ms/step median of steps 2-6 (min {min(step_ms):.2f}, max {max(step_ms):.2f}) | K2 launches 18 in 6 "
        f"steps, K1 6 (validation at steps 3, 6) | host syncs "
        f"per step {syncs[1]:.2f} at scalar_log_step=1, {syncs[1000]:.2f} at 1000 | checkpoint {nbytes} bytes, save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s, restore bit-equal ({len(flat_saved)} tensors, step, both Adam "
        f"counts, input state) | resume 3+3 vs straight 6: {resume_note} | validate_checkpoint 4 batches = hand "
        f"loop (rtol 1e-6): "
        f"kpr {results['mean_kpr_loss']:.4f} mr {results['mean_mr_loss']:.6f} PCK@0.5 {results['pck@0.5']:.4f}, "
        f"K1 12 | Predictor restored from the checkpoint bit-equal to one built from the state (64 images) "
        f"| on {card}"
    )


# ---------------------------------------------------------------------------
# the weight importers and the s2d stem


class _KerasLayer:
    """A Keras layer as the importers read it: ``.name`` and
    ``.get_weights()`` (the card's machine has no TensorFlow)."""

    def __init__(self, name, weights=()):
        self.name, self._weights = name, list(weights)

    def get_weights(self):
        return list(self._weights)


class _KerasModel:
    def __init__(self, layers):
        self.layers = layers

    def get_layer(self, name):
        return next(layer for layer in self.layers if layer.name == name)


def _keras_resnet50(rng):
    """keras.applications.ResNet50(include_top=False)'s weighted layers in
    its names and shapes, from seeded numpy: HWIO kernels (LeCun-scaled, so
    that the features stay O(1)) and biases; BN [gamma, beta, moving_mean,
    moving_variance] away from their initial values, as pretrained weights
    are."""
    import numpy as np

    from human_pose_estimation_tpu_torch.models.port_keras import STAGE_BLOCKS

    layers = []

    def conv(name, k, cin, cout):
        kernel = rng.standard_normal((k, k, cin, cout), np.float32) * np.float32(np.sqrt(1.0 / (k * k * cin)))
        layers.append(_KerasLayer(name, [kernel, (0.05 * rng.standard_normal(cout)).astype(np.float32)]))

    def bn(name, c):
        layers.append(_KerasLayer(name, [
            (1 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal(c)).astype(np.float32), rng.lognormal(0.0, 0.3, c).astype(np.float32),
        ]))

    conv("conv1_conv", 7, 3, 64)
    bn("conv1_bn", 64)
    cin = 64
    for stage, blocks in STAGE_BLOCKS.items():
        f = 64 * 2 ** (stage - 1)
        for b in range(1, blocks + 1):
            prefix = f"conv{stage + 1}_block{b}"
            if b == 1:
                conv(f"{prefix}_0_conv", 1, cin, 4 * f)
                bn(f"{prefix}_0_bn", 4 * f)
            for i, (k, ci, co) in enumerate(((1, cin, f), (3, f, f), (1, f, 4 * f)), start=1):
                conv(f"{prefix}_{i}_conv", k, ci, co)
                bn(f"{prefix}_{i}_bn", co)
            cin = 4 * f
    layers.append(_KerasLayer("avg_pool"))
    return _KerasModel(layers)


def _keras_dense(rng, name, n_in, n_out):
    import numpy as np

    return _KerasLayer(name, [(rng.standard_normal((n_in, n_out), np.float32) / np.float32(np.sqrt(n_in))),
                              (0.05 * rng.standard_normal(n_out)).astype(np.float32)])


def _reference_models(rng):
    """The reference bundle's models as stand-ins: the encoder, the
    regressor 2133 -> 1024 -> drop -> 1024 -> drop -> 85 (its output layer
    as small as the reference initializes it, so that the estimates stay
    near the mean theta) and the critic's 9 Dense layers, in their Keras
    names and shapes."""
    import numpy as np

    limit = np.sqrt(3.0 * 0.02 / (1024 + 85))
    out = _KerasLayer("dense_2", [rng.uniform(-limit, limit, (1024, 85)).astype(np.float32), np.zeros(85, np.float32)])
    regressor = _KerasModel([
        _keras_dense(rng, "dense", 2133, 1024), _KerasLayer("dropout"), _keras_dense(rng, "dense_1", 1024, 1024),
        _KerasLayer("dropout_1"), out,
    ])
    critic = _KerasModel([_keras_dense(rng, name, n_in, n_out) for name, n_in, n_out in (
        ("kcs_dense", 169, 100), ("joints_dense", 42, 100), ("combined_dense", 200, 1), ("shapes_dense_1", 10, 10),
        ("shapes_dense_2", 10, 5), ("shapes_dense_3", 5, 1), ("rotation_dense_1", 207, 300),
        ("rotation_dense_2", 300, 100), ("rotation_dense_3", 100, 1),
    )])
    return _keras_resnet50(rng), regressor, critic


def phase_weights(torch, cc, card, smpl, mean_theta):
    """The ``[weights]`` phase (``_phase_weights``) with the loop's own
    progress lines kept off the output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        line = _phase_weights(torch, cc, card, smpl, mean_theta)
    print(line, flush=True)


def _phase_weights(torch, cc, card, smpl, mean_theta):
    """The TensorFlow-free halves of the weight importers at full width, on
    stand-in Keras models from seeded numpy: (a) a ResNet-50 through
    ``port_resnet50`` into an import_encoder donor checkpoint and a Trainer
    grafted from it at [train]'s width (3 steps); (b) the reference bundle
    through ``import_reference_models`` into a checkpoint that a Predictor
    restores (64 images, bit-equal to an HMR built from the same state
    dict) and ``validate_checkpoint`` sweeps (2 batches at [eval]'s width);
    (c) the s2d stem against the standard stem on (a)'s weights: f32 and
    bf16 features, encoder forward + backward timed alternately, and the
    stem's own device time from the profiler."""
    import shutil

    import numpy as np

    from human_pose_estimation_tpu_torch.cli.import_encoder import write_donor
    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.core.smpl import save_model_npz
    from human_pose_estimation_tpu_torch.data.npz_dataset import NpzMocapPipeline
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor, serving_graph
    from human_pose_estimation_tpu_torch.models.port_keras import port_resnet50
    from human_pose_estimation_tpu_torch.models.port_reference import import_reference_models
    from human_pose_estimation_tpu_torch.models.resnet import ResNet50, convert_params_to_s2d, space_to_depth_2x2
    from human_pose_estimation_tpu_torch.train.trainer import Trainer
    from human_pose_estimation_tpu_torch.utils import checkpoint as ckpt

    n, img, p = 8, 224, 16384
    root = os.path.join(SMOKE_DIR, "weights")
    shutil.rmtree(root, ignore_errors=True)  # a step at or below the latest on disk is not saved again
    os.makedirs(root)
    model_path = os.path.join(root, "model.npz")
    save_model_npz(smpl, model_path)
    base = dict(
        smpl_model_path=model_path, batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
        mr_metric_stages="all", max_silhouette_points=p, use_gradient_penalty=True, model_dir=None, log_img_step=0,
        scalar_log_step=1, use_validation=False, checkpoint_every_epochs=1000, num_examples_override=1000 * n,
    )
    rng = np.random.default_rng(21)
    t_phase = time.perf_counter()

    # -- (a) a Keras ResNet-50 -> the donor -> a grafted Trainer, 3 steps --
    ported = port_resnet50(_keras_resnet50(rng))
    donor_dir = os.path.join(root, "donor")
    donor_cfg = Config(**{**base, "checkpoint_dir": donor_dir})
    _, written = write_donor(donor_cfg, ported, device="cuda")
    if not written or ckpt.latest_step(donor_dir) != 0:
        raise AssertionError("the donor checkpoint was not written at step 0")
    if write_donor(donor_cfg, ported, device="cuda")[1]:
        raise AssertionError("a second donor write into the same directory reported a write")
    cfg = Config(**{**base, "checkpoint_dir": os.path.join(root, "grafted"), "init_encoder_from": donor_dir})
    pairs = _train_batches(torch, smpl, n, p, img, 3, seed=22, device="cuda")
    mocap = NpzMocapPipeline(cfg, smpl, [MOCAP_SHARD], device_forward=True, seed=3, device="cuda")
    trainer = Trainer(cfg, dataset=_Resumable([b for b, _ in pairs], n), mocap_dataset=mocap, smpl=smpl,
                      device="cuda")
    own = trainer.state.hmr.encoder.state_dict()
    unequal = [k for k, v in ported.items() if not torch.equal(own[k].cpu(), v)]
    if unequal or set(own) != set(ported):
        raise AssertionError(f"the grafted encoder differs from the ported weights: {unequal[:5]}")
    metrics = []
    inner = trainer.train_step
    trainer.train_step = lambda *a: metrics.append(inner(*a)) or metrics[-1]
    k2 = cc.VALUE_GRAD_LAUNCHES
    trainer.train(max_steps=3)
    torch.cuda.synchronize()
    if cc.VALUE_GRAD_LAUNCHES - k2 != 9 or len(metrics) != 3:
        raise AssertionError(f"3 grafted steps launched K2 {cc.VALUE_GRAD_LAUNCHES - k2} times, not 9")
    for m in metrics:
        for field, value in vars(m).items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"grafted trainer metric {field} is not finite: {value}")
    step_ms = [ms for tag, step, ms in trainer.writers["train"].history if tag == "perf/step_time_ms"]
    gen_losses = [float(m.generator_loss) for m in metrics]
    del trainer, mocap, pairs, metrics
    t_a = time.perf_counter() - t_phase

    # -- (b) the reference bundle -> a checkpoint -> Predictor, validate_checkpoint
    encoder_k, regressor_k, critic_k = _reference_models(rng)
    inital_theta = (np.asarray(mean_theta.cpu()).reshape(1, 85) + 0.01 * rng.standard_normal((1, 85))).astype(
        np.float32)
    ref_dir = os.path.join(root, "reference")
    ref_cfg = Config(**{**base, "checkpoint_dir": ref_dir})
    _, written = import_reference_models(encoder_k, regressor_k, critic_k, inital_theta, ref_dir, ref_cfg,
                                         device="cuda")
    raw, step = ckpt.restore_raw(ref_dir)
    if not written or step != 0 or not np.array_equal(raw["mean_theta"].numpy().reshape(1, 85), inital_theta):
        raise AssertionError("the reference import did not write step 0 with mean theta = inital_theta")
    requests = np.random.RandomState(23).randint(0, 256, size=(64, img, img, 3)).astype("uint8")
    served = Predictor(ref_cfg.replace(batch_size=64), smpl=smpl, device="cuda").predict(requests)
    hmr = _seeded_hmr(smpl, "bfloat16", "cuda")
    hmr.load_state_dict(raw["hmr"])
    hmr.eval()
    with torch.inference_mode():
        built = serving_graph(hmr, torch.from_numpy(requests).cuda(), raw["mean_theta"].cuda().reshape(1, 85))
    built = {k: v.cpu().numpy() for k, v in built.items()}
    if set(served) != set(built) or not all(np.array_equal(served[k], built[k]) for k in built):
        worst = max(float(np.abs(served[k] - built[k]).max()) for k in built)
        raise AssertionError(f"the restored Predictor differs from an HMR of the same state dict (max {worst:.3e})")
    if not all(np.isfinite(v).all() for v in served.values()):
        raise AssertionError("the restored Predictor served non-finite values")
    val_batches = _eval_batches(torch, torch.Generator().manual_seed(24), n, p, img, 2)
    validator = Trainer(ref_cfg, val_dataset=[(b, n) for b in val_batches], validation_only=True, smpl=smpl,
                        device="cuda")
    k1 = cc.LAUNCHES
    results = validator.validate_checkpoint()
    if cc.LAUNCHES - k1 != 6:
        raise AssertionError(f"validate_checkpoint over 2 batches launched K1 {cc.LAUNCHES - k1} times, not 6")
    if not all(np.isfinite(results[k]) for k in ("mean_kpr_loss", "mean_mr_loss", "pck@0.5")):
        raise AssertionError(f"validate_checkpoint results are not finite: {results}")
    del validator, hmr, served, built
    t_b = time.perf_counter() - t_phase - t_a

    # -- (c) the s2d stem against the standard stem on (a)'s weights ------
    std = ResNet50().cuda()
    std.load_state_dict(ported)
    s2d = ResNet50(stem="s2d").cuda()
    s2d.load_state_dict(convert_params_to_s2d(ported))
    x = (torch.rand(n, img, img, 3, generator=torch.Generator().manual_seed(25)) * 2 - 1).cuda()
    std.eval()
    s2d.eval()
    with torch.no_grad():
        f32_err = _rel_l2(torch, s2d(x), std(x))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            bf16_std, bf16_s2d = std(x), s2d(x)
        bf16_err = _rel_l2(torch, bf16_s2d, bf16_std)
        bf16_vs_f32 = _rel_l2(torch, bf16_std, std(x))
    if not f32_err <= 1e-5:
        raise AssertionError(f"s2d vs standard stem f32 features: rel L2 {f32_err:.3e} > 1e-5")
    std.train()
    s2d.train()

    def fwd_bwd(model):
        def run():
            model.zero_grad(set_to_none=True)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = model(x)
            out.float().sum().backward()
            torch.cuda.synchronize()
        return run

    def stem(model, prepare):
        inp = prepare(x).detach().requires_grad_(False)

        def run():
            model.conv1.zero_grad(set_to_none=True)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = model.conv1(inp)
            out.float().sum().backward()
        return run

    for fn in (fwd_bwd(std), fwd_bwd(s2d)):
        fn()  # warm-up: cuDNN plans, allocator
    rounds = 8
    times = _alternate([fwd_bwd(std), fwd_bwd(s2d)], rounds)
    std_ms, s2d_ms = (1e3 * float(np.median(t)) for t in times)
    stem_std = _profiled_device_ms(torch, stem(std, lambda t: t.permute(0, 3, 1, 2)), calls=5)
    stem_s2d = _profiled_device_ms(
        torch, stem(s2d, lambda t: torch.nn.functional.pad(space_to_depth_2x2(t).permute(0, 3, 1, 2), (2, 1, 2, 1))),
        calls=5,
    )
    enc_std = _profiled_device_ms(torch, fwd_bwd(std), calls=3)
    enc_s2d = _profiled_device_ms(torch, fwd_bwd(s2d), calls=3)
    del std, s2d, x
    t_c = time.perf_counter() - t_phase - t_a - t_b

    return (
        f"[weights] (a) stand-in Keras ResNet-50 -> port_resnet50 -> import_encoder donor (step 0; a second write "
        f"into it writes nothing) -> Trainer(init_encoder_from) ResNet-50 {img}px bf16 batch {n} P={p} mr on 3 "
        f"stages, GP on, mocap 24 from NpzMocapPipeline: grafted encoder bit-equal to the ported state dict "
        f"({len(ported)} tensors), 3 steps {', '.join(f'{ms:.2f}' for ms in step_ms)} ms, K2 9, metrics finite, "
        f"generator_loss {gen_losses[0]:.4f} -> {gen_losses[-1]:.4f} ({t_a:.1f} s) | (b) stand-in reference bundle "
        f"(encoder, regressor 2133-1024-1024-85, 9 critic Dense, inital_theta) -> import_reference_models -> step 0 "
        f"-> Predictor restore, 64 images {img}px bf16 bit-equal to an HMR of the same state dict; "
        f"validate_checkpoint 2 batches of {n} at P={p}: kpr {results['mean_kpr_loss']:.4f} mr "
        f"{results['mean_mr_loss']:.6f} PCK@0.5 {results['pck@0.5']:.4f}, K1 6 ({t_b:.1f} s) | (c) s2d vs standard "
        f"stem, ResNet-50 on (a)'s weights, batch {n} {img}px: features rel L2 f32 {f32_err:.3e}, bf16 autocast "
        f"{bf16_err:.3e} (bf16 vs f32, standard stem: {bf16_vs_f32:.3e}); encoder forward + backward (bf16, train "
        f"mode) alternately, median of {rounds}: standard {std_ms:.3f} ms, s2d {s2d_ms:.3f} ms (host clock); "
        f"device (profiler): encoder standard {enc_std[0]:.3f} ms in {enc_std[1]:.0f} launches, s2d "
        f"{enc_s2d[0]:.3f} ms in {enc_s2d[1]:.0f}; stem conv forward + backward standard {stem_std[0]:.3f} ms in "
        f"{stem_std[1]:.0f} launches, s2d {stem_s2d[0]:.3f} ms in {stem_s2d[1]:.0f} ({t_c:.1f} s) | on {card}"
    )


# ---------------------------------------------------------------------------
# the serving stack and the int8 encoder


# QUALITY.md's silhouette distribution: the JAX generator's 640 renders at 256 px
QUALITY_SIL = {"sil_pixels_mean": 4114, "sil_pixels_p50": 3814, "sil_pixels_p99": 9214, "sil_pixels_max": 10233}


class _Epochs:
    """An image stream over rendered examples held in memory: each epoch a
    seeded shuffle, cut into HostBatches of ``batch`` uint8 canvases (the
    256 px renders themselves: the person window a tfrecord pipeline cuts
    first covers every crop the augmentation can take), the remainder
    dropped as a repeating tf.data stream drops it. ``iter`` hands back the
    one running stream, so each ``Trainer.train`` call goes on where the
    last stopped."""

    def __init__(self, examples, batch, seed):
        import numpy as np

        self.examples, self.batch = examples, batch
        self.rng = np.random.RandomState(seed)
        self._stream = self._batches()

    def _batches(self):
        while True:
            order = self.rng.permutation(len(self.examples))
            for s in range(0, len(order) - self.batch + 1, self.batch):
                yield _host_batch([self.examples[i] for i in order[s : s + self.batch]]), self.batch

    def __iter__(self):
        return self._stream


def _host_batch(examples):
    """A HostBatch of (rgb, silhouette, (3, 14) label) renders, as a
    pipeline hands it over after decode: the canvases, their full extent,
    the centre of the visible keypoints and the labels with 5 empty face
    points."""
    import numpy as np

    from human_pose_estimation_tpu_torch.data.synthetic import _center_from_label
    from human_pose_estimation_tpu_torch.train.step import HostBatch

    n, size = len(examples), examples[0][0].shape[0]
    label = np.zeros((n, 3, 19), np.float32)
    label[:, :, :14] = np.stack([e[2] for e in examples])
    return HostBatch(
        image=np.stack([e[0] for e in examples]),
        seg=np.stack([e[1] for e in examples]),
        hw=np.full((n, 2), size, np.int32),
        center=np.stack([_center_from_label(e[2]) for e in examples]).astype(np.int32),
        label=label,
    )


def closed_loop(torch, cc, device="cuda", n_train=512, n_val=128, n_mocap=8192, render=256, img=224, batch=32,
                steps=300, sil=16384, encoder_stage_sizes="", warm=10, sync_steps=5, window=30):
    """The closed loop at the quality bench's ``combined`` configuration
    (``benchmarks/quality_bench.py``): the 6890-vertex synthetic human,
    ``n_train`` + ``n_val`` renders at ``render`` px from seed 0's streams
    (the body model on ``device``, the C++ rasterizer on the host) and an
    ``n_mocap`` prior from the same distribution through an npz shard and
    ``NpzMocapPipeline``; ``Trainer`` (ResNet-50 bf16, ``img`` px, batch
    ``batch``, lr 3e-4, keypoint + mesh + critic losses with GP, the
    augmentation and the mocap body model inside the fused step) for
    ``steps`` steps, evaluated at step 0 and at the end by
    ``validate_checkpoint`` plus the vertex, Procrustes and camera-scale
    errors against the generating parameters. As in the bench, the mesh
    loss runs on the last stage only (``mr_metric_stages='last'``): K2
    once per step, K1 once per validation batch. Returns the figures;
    raises on a failed check."""
    import contextlib
    import io
    import resource
    import shutil

    import numpy as np

    from human_pose_estimation_tpu_torch import native
    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.core.smpl import smpl_forward
    from human_pose_estimation_tpu_torch.data import synthetic
    from human_pose_estimation_tpu_torch.data.npz_dataset import NpzMocapPipeline, write_mocap_npz_shard
    from human_pose_estimation_tpu_torch.data.pipeline import DevicePreprocessor
    from human_pose_estimation_tpu_torch.ops.metrics import pa_error
    from human_pose_estimation_tpu_torch.train.trainer import Trainer
    from human_pose_estimation_tpu_torch.utils.synthetic_human import synthetic_human_model

    t_phase = time.perf_counter()
    out = {}
    # -- build and asset: no numpy fallback, 640 numpy renders would take minutes
    if native.get_rasterizer() is None:
        raise AssertionError(f"the C++ rasterizer did not build: {native.BUILD_LOG.get('rasterizer', '')}")
    out["gxx_s"] = native.BUILD_SECONDS.get("rasterizer")  # None: built by an earlier run
    t0 = time.perf_counter()
    model = synthetic_human_model(num_verts=6890)
    out["model_s"] = time.perf_counter() - t0

    # -- data: the quality bench's generation at seed 0, held in memory
    seed = 0
    t0 = time.perf_counter()
    train_ex, _, sil_tr = synthetic.render_split(model, n_train, np.random.RandomState(seed + 1), render, device=device)
    val_ex, val_gt, sil_va = synthetic.render_split(model, n_val, np.random.RandomState(seed + 2), render, device=device)
    out["render_ms"] = 1e3 * (time.perf_counter() - t0) / (n_train + n_val)
    out["sil"] = synthetic.sil_stats(sil_tr + sil_va)
    root = os.path.join(SMOKE_DIR, "closed_loop")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mocap_path = os.path.join(root, "neutrSMPL_CMU_synth.npz")
    write_mocap_npz_shard(mocap_path, *synthetic.sample_mocap(n_mocap, seed))
    smpl = model.to(device)
    with torch.no_grad():
        gt_verts = smpl_forward(
            smpl, torch.from_numpy(val_gt["beta"]).to(device), torch.from_numpy(val_gt["theta"]).to(device),
            joint_type="lsp",
        ).verts

    # -- the trainer at the bench's combined configuration
    cfg = Config(
        datasets=["synth_train"], val_datasets=["synth_val"], mocap_datasets=["CMU"], num_examples_override=n_train,
        img_size=img, batch_size=batch, epoch=10**9, generator_lr=3e-4, use_kpr_loss=True, use_mesh_repro_loss=True,
        encoder_only=False, use_gradient_penalty=True, max_silhouette_points=sil, mr_metric_stages="last",
        encoder_dtype="bfloat16", encoder_stage_sizes=encoder_stage_sizes, use_validation=False, log_img_step=0,
        checkpoint_every_epochs=10**9, scalar_log_step=1, fuse_preprocess=True, seed=seed, model_dir=None,
        checkpoint_dir=os.path.join(root, "ckpt"),
    )
    prep = DevicePreprocessor(cfg, augment=False, device=device)
    val = []
    for s in range(0, n_val, batch):
        chunk = val_ex[s : s + batch]
        val.append((prep(_host_batch(chunk)._asdict()), len(chunk)))
    mocap = NpzMocapPipeline(cfg, smpl, [mocap_path], device_forward=False, seed=seed, device=device)
    trainer = Trainer(cfg, dataset=_Epochs(train_ex, batch, seed), mocap_dataset=mocap, val_dataset=val,
                      smpl=smpl, device=device)
    log = io.StringIO()  # the loop's progress and epoch lines

    val_step = trainer.val_step

    def evaluate(step):
        # one sweep of validate_checkpoint; its val_step's vertices and
        # cameras are kept for the errors against the generating parameters
        outs = []

        def recording(*args):
            outs.append(val_step(*args))
            return outs[-1]

        trainer.val_step = recording
        k1 = cc.LAUNCHES
        try:
            with contextlib.redirect_stdout(log):
                res = trainer.validate_checkpoint(restore=False)
        finally:
            trainer.val_step = val_step
        launches = cc.LAUNCHES - k1
        if device == "cuda" and launches != len(val):
            raise AssertionError(f"an evaluation launched K1 {launches} times, not once per batch ({len(val)})")
        verrs, paerrs, scales, at = [], [], [], 0
        for o, (_, n) in zip(outs, val, strict=True):
            pv, gv = o["verts"][:n].double().cpu(), gt_verts[at : at + n].double().cpu()
            verrs.append(torch.linalg.vector_norm(pv - gv, dim=-1).mean(dim=-1))
            paerrs.append(pa_error(pv, gv))
            scales.append(o["cams"][:n, 0].double().cpu())
            at += n
        gt_s = torch.from_numpy(val_gt["cam"][:, 0]).double()
        row = {
            "config": "combined", "seed": seed, "step": step,
            "rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 1),
            "kpr": round(res["mean_kpr_loss"], 4), "mr": round(res["mean_mr_loss"], 4),
            "pck@0.5": round(res["pck@0.5"], 4), "pck_auc": round(res["pck_auc@0.5"], 4),
            "vert_err": round(float(torch.cat(verrs).mean()), 4),
            "pa_vert_err": round(float(torch.cat(paerrs).mean()), 4),
            "cam_scale_ratio": round(float((torch.cat(scales) / gt_s.clamp(min=1e-6)).mean()), 4),
        }
        bad = [k for k, v in row.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"evaluation at step {step}: {bad} not finite: {row}")
        return row

    out["rows"] = [evaluate(0)]
    k2 = cc.VALUE_GRAD_LAUNCHES
    kpr = []
    with contextlib.redirect_stdout(log):
        kpr += trainer.train(max_steps=warm)["kpr"]  # the first step allocates the optimizer state
        if device == "cuda":
            holder = {}
            syncs = _host_syncs(torch, lambda: holder.setdefault("kpr", trainer.train(max_steps=sync_steps)["kpr"]))
            kpr += holder["kpr"]
            out["syncs_per_step"] = syncs / sync_steps
        else:
            kpr += trainer.train(max_steps=sync_steps)["kpr"]
            out["syncs_per_step"] = None
        history = trainer.writers["train"].history
        logged = len(history)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kpr += trainer.train(max_steps=steps - warm - sync_steps)["kpr"]
        if device == "cuda":
            torch.cuda.synchronize()
        timed = steps - warm - sync_steps
        out["wall_ms"] = 1e3 * (time.perf_counter() - t0) / timed
        out["step_ms"] = float(np.median([ms for tag, _, ms in history[logged:] if tag == "perf/step_time_ms"]))
    out["k2"] = cc.VALUE_GRAD_LAUNCHES - k2
    if trainer.state.step != steps or len(kpr) != steps:
        raise AssertionError(f"the loop took {trainer.state.step} steps and logged {len(kpr)} KPR values, not {steps}")
    if device == "cuda" and out["k2"] != steps:
        raise AssertionError(f"{steps} steps launched K2 {out['k2']} times, not once per step")
    if out["syncs_per_step"] is not None and out["syncs_per_step"] > 1:
        raise AssertionError(f"{out['syncs_per_step']} host syncs per logged step (at most 1)")
    kpr = np.asarray(kpr)
    if not np.isfinite(kpr).all():
        raise AssertionError("a training KPR value is not finite")
    out["kpr_head"], out["kpr_tail"] = float(kpr[:window].mean()), float(kpr[-window:].mean())
    if not out["kpr_tail"] < out["kpr_head"]:
        raise AssertionError(f"training KPR did not fall: first {window} {out['kpr_head']}, last {out['kpr_tail']}")
    out["rows"].append(evaluate(steps))
    out["steps"], out["phase_s"] = steps, time.perf_counter() - t_phase
    if device == "cuda":  # where a step's time goes, after the measured run
        with contextlib.redirect_stdout(log):
            out["device_ms"], out["launches"] = _profiled_device_ms(torch, lambda: trainer.train(max_steps=1), calls=3)
    return out


def phase_closed_loop(torch, cc, card):
    """The ``[closed-loop]`` phase: ``closed_loop`` at full width on the
    card, one line for the build and the data, one per evaluation in the
    quality bench's row schema, one for the training."""
    r = closed_loop(torch, cc)
    gxx = "cached" if r["gxx_s"] is None else f"{r['gxx_s']:.2f} s"
    print(f"[closed-loop] g++ rasterizer {gxx} | synthetic_human_model(6890) {r['model_s']:.2f} s | {card}", flush=True)
    sil = " / ".join(str(r["sil"][k]) for k in QUALITY_SIL)
    ref = " / ".join(f"{v:,}" for v in QUALITY_SIL.values())
    print(
        f"[closed-loop] data: 640 renders at 256 px, {r['render_ms']:.2f} ms per render (body model on the card, "
        f"C++ rasterizer) | silhouette pixels mean / p50 / p99 / max {sil} (QUALITY.md, the JAX generator: {ref}) "
        f"| mocap 8192 through NpzMocapPipeline | {card}",
        flush=True,
    )
    for row in r["rows"]:
        print(f"[closed-loop] {json.dumps(row)}", flush=True)
    first, last = r["rows"]
    print(
        f"[closed-loop] train: {r['steps']} steps ResNet-50 224 px bf16 batch 32, {r['step_ms']:.2f} ms per step "
        f"(median of the loop's own, {r['wall_ms']:.2f} by the wall clock) | train KPR first 30 {r['kpr_head']:.3f} "
        f"-> last 30 {r['kpr_tail']:.3f} | val KPR {first['kpr']} -> {last['kpr']}, PCK@0.5 {first['pck@0.5']} -> "
        f"{last['pck@0.5']} | K2 {r['k2']} launches (1 per step), K1 1 per validation batch | host syncs per logged "
        f"step {r['syncs_per_step']:.2f} | phase {r['phase_s']:.1f} s | afterwards, one step (profiler, 3 steps): "
        f"device busy {r['device_ms']:.3f} ms ({100 * r['device_ms'] / r['step_ms']:.1f}% of the median step) in "
        f"{r['launches']:.0f} launches | {card}",
        flush=True,
    )


def _perturbed_weights(torch, smpl, seed=11):
    """The seeded HMR's state dict with its encoder's BN parameters, running
    statistics and convolution biases perturbed as
    tests/test_quantize.py::_realistic_variables does (var * exp(0.1 N);
    mean, bias and scale + 0.05 N), so that activations survive the ReLUs
    and folding is not trivial."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in _seeded_hmr(smpl, "bfloat16", "cuda").state_dict().items():
        if k.startswith("encoder.") and v.is_floating_point():
            noise = torch.randn(v.shape, generator=gen).to(v.device)
            if k.endswith("running_var"):
                v = v * torch.exp(0.1 * noise)
            elif k.endswith(("running_mean", ".bias")) or (k.endswith(".weight") and v.dim() == 1):
                v = v + 0.05 * noise
        out[k] = v
    return out


def _rel_l2(torch, a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _alternate(fns, rounds):
    """Host seconds of each of ``fns`` over ``rounds`` rounds, their order
    reversed every other round (a, b, b, a, ...); each call ends with the
    results on the host."""
    times = [[] for _ in fns]
    for r in range(rounds):
        order = list(range(len(fns)))[:: 1 if r % 2 == 0 else -1]
        for i in order:
            t0 = time.perf_counter()
            fns[i]()
            times[i].append(time.perf_counter() - t0)
    return times


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _int8_breakdown(torch, q, fn):
    """Device ms of one call of ``fn`` (the int8 encoder) under the
    profiler: in total, inside ``_int_mm`` (the int8 GEMMs), inside the
    rest of ``_conv_i8`` (the im2col copies, the K padding and the
    accumulator's cast) and outside both (quantize and dequantize
    epilogues, residual adds, the pool); and its kernel launches.
    ``_conv_i8`` and ``_int_mm`` are wrapped in record_function ranges for
    this call only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    conv, mm = q._conv_i8, q._int_mm

    def ranged(name, f):
        def call(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return call

    q._conv_i8, q._int_mm = ranged("smoke.conv_i8", conv), ranged("smoke.int_mm", mm)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        q._conv_i8, q._int_mm = conv, mm
    events = prof.key_averages()
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    span = {
        e.key: e.device_time_total / 1e3 for e in events
        if e.key.startswith("smoke.") and e.device_type == torch.autograd.DeviceType.CPU
    }
    gemm = span.get("smoke.int_mm", 0.0)
    conv_ms = span.get("smoke.conv_i8", 0.0)
    return total, gemm, conv_ms - gemm, total - conv_ms, sum(e.count for e in kernels)


def phase_int8(torch, card, smpl, mean_theta):
    """The post-training int8 encoder at full width: ResNet-50, 224 px,
    batch 64, calibrated on 64 images, on weights whose BN is perturbed
    (``_perturbed_weights``). Its img/s against the bf16 Predictor, timed
    alternately on the same requests; the int8 features against the f32
    encoder (relative L2, limit 0.03); the int8 encoder on the card
    against the CPU on two images (relative L2, limit 1e-3: the integer
    accumulations are exact); the device time of its GEMMs against the
    im2col copies and the epilogues; lazy calibration from a padded first
    batch; an uncalibrated export refused. Returns the int8 predictor."""
    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.infer.export import export_predictor
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor, normalize
    from human_pose_estimation_tpu_torch.models import quantize as q
    from human_pose_estimation_tpu_torch.models.hmr import HMR

    batch, img = 64, 224
    weights = _perturbed_weights(torch, smpl)
    cfg = Config(batch_size=batch, img_size=img, encoder_dtype="bfloat16")
    rng = np.random.RandomState(12)
    calib = rng.randint(0, 256, size=(batch, img, img, 3)).astype("uint8")
    requests = rng.randint(0, 256, size=(5 * batch, img, img, 3)).astype("uint8")
    t0 = time.perf_counter()
    int8 = Predictor(cfg, smpl=smpl, variables=weights, mean_theta=mean_theta, encoder_int8=True,
                     calibration_images=calib)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    bf16 = Predictor(cfg, smpl=smpl, variables=weights, mean_theta=mean_theta)
    qp, stages = int8.encoder_qparams, int8.hmr.encoder.stage_sizes
    if qp["act"] is None or len(qp["act"]) != 2 + 3 * sum(stages):
        raise AssertionError("the int8 predictor did not calibrate every activation site")

    outs = {"bf16": bf16.predict(requests), "int8": int8.predict(requests)}  # warm-up, and the outputs
    for name, out in outs.items():
        for k, a in out.items():
            if a.shape[0] != 5 * batch or not np.isfinite(a).all():
                raise AssertionError(f"{name} output {k}: shape {a.shape} or not finite")
    rounds = 4
    t_bf16, t_int8 = _alternate([lambda: bf16.predict(requests), lambda: int8.predict(requests)], rounds)
    ips_bf16, ips_int8 = 5 * batch / float(np.median(t_bf16)), 5 * batch / float(np.median(t_int8))
    verts_diff = float(np.abs(outs["int8"]["generated_verts"] - outs["bf16"]["generated_verts"]).max())

    # the int8 features against the f32 encoder on one batch
    f32 = HMR(smpl, encoder_dtype="float32", device="cuda")
    f32.load_state_dict(weights)
    x = normalize(torch.from_numpy(requests[:batch]).cuda())
    with torch.inference_mode():
        feat_f32 = f32.encoder(x)
        feat_i8 = q.resnet_apply_int8(qp["weights"], x, stages, act_scales=qp["act"])
        feat_bf16 = bf16.hmr._encode(x, None)
    rel_f32, rel_bf16 = _rel_l2(torch, feat_i8, feat_f32), _rel_l2(torch, feat_bf16, feat_f32)
    if not rel_f32 <= 0.03:
        raise AssertionError(f"int8 features are {rel_f32:.4f} from the f32 encoder's (relative L2; limit 0.03)")

    # the same int8 encoder on the card and on the CPU, two images
    with torch.inference_mode():
        on_card = q.resnet_apply_int8(qp["weights"], x[:2], stages, act_scales=qp["act"]).cpu()
        on_cpu = q.resnet_apply_int8(_tree_to(qp["weights"], "cpu"), x[:2].cpu(), stages,
                                     act_scales=_tree_to(qp["act"], "cpu"))
    rel_cpu = _rel_l2(torch, on_card, on_cpu)
    if not rel_cpu <= 1e-3:
        raise AssertionError(f"the int8 encoder on the card is {rel_cpu:.2e} from the CPU's (relative L2; limit 1e-3)")

    # where the int8 encoder's device time goes, one batch
    with torch.inference_mode():
        total, gemm, im2col, rest, launches = _int8_breakdown(
            torch, q, lambda: q.resnet_apply_int8(qp["weights"], x, stages, act_scales=qp["act"])
        )
    with torch.inference_mode():
        enc_bf16_ms, enc_bf16_launches = _profiled_device_ms(torch, lambda: bf16.hmr._encode(x, None), calls=3)

    # lazy calibration from a padded first batch, and the export refusal
    lazy = Predictor(cfg, smpl=smpl, variables=weights, mean_theta=mean_theta, encoder_int8=True)
    try:
        export_predictor(lazy, os.path.join(SMOKE_DIR, "never.pt2"), platforms=("cuda",))
        raise AssertionError("an uncalibrated int8 predictor was exported")
    except ValueError as e:
        if "UNCALIBRATED" not in str(e):
            raise
    lazy.predict(np.zeros((batch, img, img, 3), np.uint8), calibrate=False)
    if lazy.encoder_qparams["act"] is not None:
        raise AssertionError("a warm-up call (calibrate=False) froze the int8 scales")
    lazy.predict(requests[:37])
    act = lazy.encoder_qparams["act"]
    want = q.calibrate_resnet(lazy.encoder_qparams["weights"], normalize(torch.from_numpy(requests[:37]).cuda()),
                              stages)
    if act is None or any(not torch.equal(act[s], want[s]) for s in want):
        raise AssertionError("lazy calibration did not take the 37 unpadded rows alone")
    padded = q.calibrate_resnet(lazy.encoder_qparams["weights"], normalize(torch.from_numpy(
        np.concatenate([requests[:37], np.zeros((batch - 37, img, img, 3), np.uint8)])).cuda()), stages)
    moved = sum(not torch.equal(padded[s], want[s]) for s in want)
    print(
        f"[int8] PTQ encoder ResNet-50 {img}px batch {batch}, calibrated on {batch} images (fold + quantize + "
        f"calibrate {quantize_s:.2f} s): {ips_int8:.1f} img/s against bf16 {ips_bf16:.1f} "
        f"({ips_int8 / ips_bf16:.3f}x; median of {rounds} alternated runs of {5 * batch} uint8 images each; int8 "
        f"min/max {5 * batch / max(t_int8):.1f}/{5 * batch / min(t_int8):.1f}, bf16 {5 * batch / max(t_bf16):.1f}/"
        f"{5 * batch / min(t_bf16):.1f}) | features vs f32: int8 {rel_f32:.4f} (limit 0.03), bf16 {rel_bf16:.4f} "
        f"(relative L2); verts int8 vs bf16 max {verts_diff:.3e} | card vs CPU, 2 images: {rel_cpu:.2e} (limit "
        f"1e-3) | one batch of the encoder (profiler): {total:.3f} ms in {launches} launches: _int_mm "
        f"{gemm:.3f} ms ({100 * gemm / total:.1f}%), im2col + K pad + accumulator cast {im2col:.3f} ms "
        f"({100 * im2col / total:.1f}%), epilogues, adds and pool {rest:.3f} ms ({100 * rest / total:.1f}%); the "
        f"bf16 encoder {enc_bf16_ms:.3f} ms in {enc_bf16_launches:.0f} launches | lazy calibration: warm-up keeps "
        f"none, a first batch of 37 padded to {batch} calibrates on its 37 rows ({moved} of {len(want)} scales "
        f"would move with the padding) | uncalibrated export refused | on {card}",
        flush=True,
    )
    return int8


def phase_int8_eval(torch, cc, card, smpl, mean_theta, num_batches=6):
    """The int8 serving graph under evaluation: make_val_step with
    encoder_qparams at ``[eval]``'s configuration (batch 8, P=16384, mesh
    loss on 3 stages), calibrated on the first batch, against the float
    step on the same HMR and batches, timed alternately; K1 three times per
    batch; mr_losses finite and within 5% of the float step's; the int8
    features against the float (bf16) encoder; then
    Trainer.validate_checkpoint with encoder_int8 on ``[trainer]``'s
    checkpoint."""
    import contextlib
    import io

    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.models import quantize as q
    from human_pose_estimation_tpu_torch.models.critic import Critic
    from human_pose_estimation_tpu_torch.models.hmr import HMR
    from human_pose_estimation_tpu_torch.train.step import make_val_step
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    n, img, p = 8, 224, 16384
    cfg = Config(batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
                 mr_metric_stages="all", max_silhouette_points=p)
    hmr = HMR(smpl, encoder_dtype="bfloat16", device="cuda")
    hmr.load_state_dict(_perturbed_weights(torch, smpl))
    gen = torch.Generator().manual_seed(13)
    critic = Critic()
    critic.reset_parameters(gen)
    critic = critic.cuda().eval()
    val_step = make_val_step(hmr, critic, cfg)
    batches = _eval_batches(torch, gen, n, p, img, num_batches + 1)
    qp = hmr.quantize_encoder(calibration_images=batches[0].images)
    mt = mean_theta.cuda()
    k1 = cc.LAUNCHES
    val_step(mt, batches[0])  # warm-up, both
    val_step(mt, batches[0], qp)
    torch.cuda.synchronize()

    float_ms, int8_ms, worst_mr = [], [], 0.0
    for i, batch in enumerate(batches[1:]):
        got = {}
        for mode in (("float", "int8") if i % 2 == 0 else ("int8", "float")):
            before = cc.LAUNCHES
            t0 = time.perf_counter()
            got[mode] = val_step(mt, batch, qp if mode == "int8" else None)
            torch.cuda.synchronize()
            (int8_ms if mode == "int8" else float_ms).append(1e3 * (time.perf_counter() - t0))
            if cc.LAUNCHES - before != 3:
                raise AssertionError(f"a {mode} eval batch launched K1 {cc.LAUNCHES - before} times, not 3")
        mr_f, mr_i = got["float"]["mr_losses"], got["int8"]["mr_losses"]
        if not bool(torch.isfinite(mr_i).all()):
            raise AssertionError(f"int8 mr_losses {mr_i.tolist()} are not finite")
        rel = float(((mr_i - mr_f).abs() / mr_f.abs()).max())
        if not rel <= 0.05:
            raise AssertionError(f"int8 mr_losses {mr_i.tolist()} are {rel:.3f} from the float step's {mr_f.tolist()}")
        worst_mr = max(worst_mr, rel)
    with torch.no_grad():
        x = batches[1].images
        rel_feat = _rel_l2(torch, q.resnet_apply_int8(qp["weights"], x, hmr.encoder.stage_sizes, act_scales=qp["act"]),
                           hmr._encode(x, None))

    # validate_checkpoint with encoder_int8 on [trainer]'s checkpoint
    ckdir = os.path.join(SMOKE_DIR, "trainer", "straight")
    tcfg = cfg.replace(encoder_int8=True, checkpoint_dir=ckdir, model_dir=None, log_img_step=0)
    trainer = Trainer(tcfg, val_dataset=[(b, n) for b in batches[1:5]], validation_only=True, smpl=smpl,
                      device="cuda")
    before = cc.LAUNCHES
    with contextlib.redirect_stdout(io.StringIO()):  # its own summary lines
        results = trainer.validate_checkpoint()
    if cc.LAUNCHES - before != 12 or not all(np.isfinite(results[k]) for k in ("mean_kpr_loss", "mean_mr_loss")):
        raise AssertionError(f"int8 validate_checkpoint: {results}, K1 launched {cc.LAUNCHES - before} times (not 12)")
    print(
        f"[int8-eval] make_val_step(encoder_qparams) batch {n} P={p} mr on 3 stages, calibrated on the first "
        f"batch, against the float (bf16) step alternately over {num_batches} batches: {np.median(int8_ms):.2f} "
        f"vs {np.median(float_ms):.2f} ms/batch median (int8 min {min(int8_ms):.2f} max {max(int8_ms):.2f}; float "
        f"min {min(float_ms):.2f} max {max(float_ms):.2f}) | K1 launches {cc.LAUNCHES - k1} (3 per batch, both "
        f"steps, and 12 in validate_checkpoint) | int8 mr_losses finite, at most {100 * worst_mr:.2f}% from the "
        f"float step's (limit 5%) | int8 features vs the bf16 encoder {rel_feat:.4f} (relative L2) | "
        f"validate_checkpoint(encoder_int8) on [trainer]'s step {trainer.state.step} checkpoint, 4 batches: kpr "
        f"{results['mean_kpr_loss']:.4f} mr {results['mean_mr_loss']:.6f} PCK@0.5 {results['pck@0.5']:.4f} "
        f"| on {card}",
        flush=True,
    )


def _bf16_predictor(torch, smpl, mean_theta, batch=64, img=224):
    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor

    cfg = Config(batch_size=batch, img_size=img, encoder_dtype="bfloat16")
    return Predictor(cfg, smpl=smpl, variables=_seeded_hmr(smpl, "bfloat16", "cuda").state_dict(),
                     mean_theta=mean_theta)


def _row_diff(out, direct, i):
    """(largest absolute difference, bit-equal) of one result dict against
    row i of a batched one."""
    import numpy as np

    diff = max(float(np.abs(out[k] - direct[k][i]).max()) for k in direct)
    return diff, all(np.array_equal(out[k], direct[k][i]) for k in direct)


def phase_batching(torch, card, pred, images):
    """BatchingPredictor over the full-width bf16 Predictor (batch 64): 16
    client threads each submit 40 single uint8 images back to back (640 in
    all) and then wait, max_latency_ms=5, at pipeline_depth 1 and 2, timed
    alternately with a direct predict of the 640 (1, 2, direct, direct, 2,
    1, 1, 2, direct); img/s, p50 and p99 request latency, batches and padded slots; host
    syncs per batch at depth 2 and in predict_async alone; every result
    against the direct predict of its image (atol 1e-5)."""
    import numpy as np

    import threading

    from human_pose_estimation_tpu_torch.infer.serving import BatchingPredictor

    direct = pred.predict(images)  # also the warm-up
    clients, per = 16, len(images) // 16

    def run(depth):
        bp = BatchingPredictor(pred, max_latency_ms=5.0, pipeline_depth=depth)
        lat, res = [0.0] * len(images), [None] * len(images)

        def client(c):
            idx = range(c * per, (c + 1) * per)
            sent = {i: (time.perf_counter(), bp.submit(images[i])) for i in idx}
            for i, (t0, fut) in sent.items():
                res[i] = fut.result(timeout=300)
                lat[i] = time.perf_counter() - t0  # the wait of a result taken in order

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        secs = time.perf_counter() - t0
        bp.close()
        if any(t.is_alive() for t in threads) or any(r is None for r in res):
            raise AssertionError(f"depth {depth}: a client did not finish")
        return secs, lat, res, dict(bp.stats)

    def run_direct(_):
        t0 = time.perf_counter()
        pred.predict(images)
        return time.perf_counter() - t0, None, None, None

    runs = {1: [], 2: [], "direct": []}
    for depth in (1, 2, "direct", "direct", 2, 1, 1, 2, "direct"):
        runs[depth].append(run_direct(depth) if depth == "direct" else run(depth))
    direct_ips = [len(images) / r[0] for r in runs.pop("direct")]
    t0 = time.perf_counter()
    np.stack(list(images[:64]))
    stack_ms = 1e3 * (time.perf_counter() - t0)
    worst, bit_equal = 0.0, True
    for depth, rs in runs.items():
        for _, _, res, stats in rs:
            if stats["requests"] != len(images):
                raise AssertionError(f"depth {depth}: stats {stats}")
            for i, out in enumerate(res):
                d, eq = _row_diff(out, direct, i)
                worst, bit_equal = max(worst, d), bit_equal and eq
    if not worst <= 1e-5:
        raise AssertionError(f"a batched result is {worst:.3e} from the direct predict (atol 1e-5)")

    syncs_batches = []

    def synced():
        syncs_batches.append(run(2)[3]["batches"])

    syncs = _host_syncs(torch, synced)
    handle_syncs = _host_syncs(torch, lambda: syncs_batches.append(pred.predict_async(images[:64])))
    pred.predict_fetch(syncs_batches.pop())

    parts = []
    for depth in (1, 2):
        secs = [r[0] for r in runs[depth]]
        lat = np.concatenate([np.asarray(r[1]) for r in runs[depth]]) * 1e3
        stats = runs[depth][0][3]
        parts.append(
            f"depth {depth}: {len(images) / np.median(secs):.1f} img/s (runs {', '.join(f'{len(images) / s:.1f}' for s in secs)}), "
            f"latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms, "
            f"{stats['batches']} batches, {stats['padded_slots']} padded slots"
        )
    print(
        f"[batching] BatchingPredictor over Predictor ResNet-50 224px bf16 batch 64, {clients} threads x {per} "
        f"uint8 images back to back, max_latency_ms=5, alternated 1, 2, direct, direct, 2, 1, 1, 2, direct | {' | '.join(parts)} "
        f"| direct predict of the 640 (10 batches enqueued, then fetched): {np.median(direct_ips):.1f} img/s (runs "
        f"{', '.join(f'{v:.1f}' for v in direct_ips)}) | np.stack of 64 requests {stack_ms:.2f} ms | host syncs "
        f"{syncs / syncs_batches[0]:.2f} per batch at depth 2 ({syncs} in {syncs_batches[0]} batches), "
        f"{handle_syncs} in predict_async | every result vs the direct predict: max {worst:.3e} (atol 1e-5)"
        f"{', bit-equal' if bit_equal else ''} | on {card}",
        flush=True,
    )


def _png_bytes(img) -> bytes:
    """An 8-bit RGB PNG of ``img`` written with zlib, every row with the
    Sub filter."""
    import numpy as np

    import struct
    import zlib

    h, w, _ = img.shape
    x = img.reshape(h, w, 3).astype(np.int16)
    sub = np.concatenate([x[:, :1], x[:, 1:] - x[:, :-1]], axis=1).astype(np.uint8).reshape(h, w * 3)
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


_HTTP_CLIENTS = """
import json, os, sys, threading, time, urllib.request
port, root, clients, per = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
pngs = [open(os.path.join(root, f), "rb").read() for f in sorted(os.listdir(root)) if f.endswith(".png")]
lat, lock = [], threading.Lock()

def client(c):
    for j in range(per):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=pngs[(c * per + j) % len(pngs)],
                                     method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            resp.read()
        with lock:
            lat.append(time.perf_counter() - t0)

threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"secs": time.perf_counter() - t0, "lat": lat}))
"""


def phase_http(torch, card, pred, images):
    """make_server on 127.0.0.1:0 over a BatchingPredictor (depth 2,
    max_latency_ms=5) over the bf16 Predictor. A client process of its own
    (so that the load shares no interpreter lock with the server) runs 8
    threads that POST 224 px PNGs (written here with zlib), 32 each,
    waiting for each answer: requests/s, p50 and p99 latency; the same load
    again at a thread switch interval of 0.5 ms. Then the raw, json and
    filtered forms, a bad request (400) and /healthz; response bytes per
    form; the raw arrays against the direct predict; the host's own cost
    of a decode and of a compressed response."""
    import io
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from human_pose_estimation_tpu_torch.infer.http_server import make_server
    from human_pose_estimation_tpu_torch.infer.serving import BatchingPredictor

    root = os.path.join(SMOKE_DIR, "http")
    os.makedirs(root, exist_ok=True)
    pngs = [_png_bytes(im) for im in images[:64]]
    for i, body in enumerate(pngs):
        with open(os.path.join(root, f"{i:02d}.png"), "wb") as f:
            f.write(body)
    direct = pred.predict(images[:64])
    bp = BatchingPredictor(pred, max_latency_ms=5.0, pipeline_depth=2)
    httpd = make_server(bp, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def post(i, query="", headers=None, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict{query}", data=body or pngs[i],
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    try:
        for i in range(8):
            post(i)  # warm-up
        clients, per = 8, 32

        def load():
            """(seconds, latencies, batches, padded slots) of one run of the client process."""
            before = dict(bp.stats)
            proc = subprocess.run([sys.executable, "-c", _HTTP_CLIENTS, str(port), root, str(clients), str(per)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"the client process failed: {proc.stderr[-2000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            if len(out["lat"]) != clients * per:
                raise AssertionError(f"{len(out['lat'])} of {clients * per} requests answered")
            return (out["secs"], out["lat"], bp.stats["batches"] - before["batches"],
                    bp.stats["padded_slots"] - before["padded_slots"])

        secs, lat, batches, padded = load()
        # the same load with the interpreter's thread switch interval at
        # 0.5 ms instead of 5: what the server's threads cost the
        # dispatcher, whose eager forward takes and gives back the lock at
        # every op
        interval = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        try:
            fast = load()
        finally:
            sys.setswitchinterval(interval)
        sizes, worst, bit_equal = {}, 0.0, True
        for i in range(4):
            z = np.load(io.BytesIO(post(i, "?format=raw")))
            d, eq = _row_diff({k: z[k] for k in z.files}, direct, i)
            worst, bit_equal = max(worst, d), bit_equal and eq
        if not worst <= 1e-5:
            raise AssertionError(f"the raw npz is {worst:.3e} from the direct predict (atol 1e-5)")
        sizes["npz"] = len(post(0))
        sizes["raw"] = len(post(0, "?format=raw"))
        body = post(0, headers={"Accept": "application/json"})
        sizes["json"] = len(body)
        if set(json.loads(body)) != {"generated_cams", "generated_joints", "theta"}:
            raise AssertionError(f"json keys {sorted(json.loads(body))}")
        body = post(0, "?outputs=generated_joints,generated_cams")
        sizes["npz joints+cams"] = len(body)
        if set(np.load(io.BytesIO(body)).files) != {"generated_joints", "generated_cams"}:
            raise AssertionError("the outputs filter did not hold")
        try:
            post(0, body=b"not an image")
            raise AssertionError("a bad request was answered 200")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health["status"] != "ok" or health["requests"] < clients * per:
            raise AssertionError(f"/healthz {health}")
        t0 = time.perf_counter()
        for i in range(8):
            pred.predict(images[i : i + 1])
        one_ms = 1e3 * (time.perf_counter() - t0) / 8
        from human_pose_estimation_tpu_torch.utils.image import decode_image

        t0 = time.perf_counter()
        for body in pngs[:16]:
            decode_image(body)
        decode_ms = 1e3 * (time.perf_counter() - t0) / 16
        t0 = time.perf_counter()
        for i in range(16):
            np.savez_compressed(io.BytesIO(), **{k: v[i] for k, v in direct.items()})
        npz_ms = 1e3 * (time.perf_counter() - t0) / 16
    finally:
        httpd.shutdown()
        httpd.server_close()
        bp.close()
    lat_ms = np.asarray(lat) * 1e3
    print(
        f"[http] make_server over BatchingPredictor (depth 2, 5 ms) over Predictor ResNet-50 224px bf16 batch 64: "
        f"a client process of {clients} threads x {per} PNG posts (224x224, Sub rows, "
        f"{np.mean([len(b) for b in pngs]):.0f} B) waiting for each answer: {clients * per / secs:.1f} requests/s, "
        f"latency p50 {np.percentile(lat_ms, 50):.1f} ms p99 {np.percentile(lat_ms, 99):.1f} ms, {batches} batches "
        f"({clients * per / batches:.2f} requests each, {padded} padded slots; {1e3 * secs / batches:.1f} ms of wall "
        f"per batch, a direct predict of one image {one_ms:.1f} ms; on the host, alone: decode_image {decode_ms:.2f} "
        f"ms per PNG, the compressed npz {npz_ms:.2f} ms per response) | the same load at a thread switch "
        f"interval of 0.5 ms (not 5): {clients * per / fast[0]:.1f} requests/s, p50 "
        f"{np.percentile(np.asarray(fast[1]) * 1e3, 50):.1f} ms, {fast[2]} batches | response bytes "
        f"{', '.join(f'{k} {v}' for k, v in sizes.items())} | raw arrays vs the direct predict max {worst:.3e} "
        f"(atol 1e-5){', bit-equal' if bit_equal else ''} | bad request 400, /healthz ok | on {card}",
        flush=True,
    )


def phase_export(torch, card, pred, int8, images):
    """export_predictor at full width (bf16, batch 64) for cuda and cpu:
    the artifact's bytes and export seconds; ExportedPredictor on cuda
    against the live Predictor over 64 + 37 images (padding, and a second
    batch), atol 1e-5; the img/s of both, timed alternately; the int8
    predictor's artifact (cuda) against it, atol 5e-3; the artifact loaded
    and run in a fresh process with only torch and the loader imported."""
    import numpy as np

    from human_pose_estimation_tpu_torch.infer.export import ExportedPredictor, export_predictor

    root = os.path.join(SMOKE_DIR, "export")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "model.pt2")
    t0 = time.perf_counter()
    meta = export_predictor(pred, path, platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    ep = ExportedPredictor(path)
    load_s = time.perf_counter() - t0
    sample = images[: 64 + 37]
    got, want = ep.predict(sample), pred.predict(sample)
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    if set(got) != set(want) or not diff <= 1e-5:
        raise AssertionError(f"the artifact is {diff:.3e} from the live Predictor (atol 1e-5)")
    bit_equal = all(np.array_equal(got[k], want[k]) for k in want)
    timed = images[:320]
    t_art, t_live = _alternate([lambda: ep.predict(timed), lambda: pred.predict(timed)], 6)

    path8 = os.path.join(root, "model_int8.pt2")
    t0 = time.perf_counter()
    export_predictor(int8, path8, platforms=("cuda",))
    export8_s = time.perf_counter() - t0
    got8, want8 = ExportedPredictor(path8).predict(images[:64]), int8.predict(images[:64])
    diff8 = max(float(np.abs(got8[k] - want8[k]).max()) for k in want8)
    if not diff8 <= 5e-3:
        raise AssertionError(f"the int8 artifact is {diff8:.3e} from the live int8 Predictor (atol 5e-3)")

    np.save(os.path.join(root, "images.npy"), images[:64])
    code = (
        "import sys, numpy as np\n"
        "from human_pose_estimation_tpu_torch.infer.export import ExportedPredictor\n"
        f"out = ExportedPredictor({path!r}).predict(np.load({os.path.join(root, 'images.npy')!r}))\n"
        f"np.save({os.path.join(root, 'verts.npy')!r}, out['generated_verts'])\n"
        "print(sorted(m for m in sys.modules if m.startswith(('human_pose_estimation_tpu', 'jax'))))\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True, text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the fresh process failed: {proc.stderr[-2000:]}")
    loaded = proc.stdout.strip().splitlines()[-1]
    allowed = "['human_pose_estimation_tpu_torch', 'human_pose_estimation_tpu_torch.infer', " \
              "'human_pose_estimation_tpu_torch.infer.export']"
    if loaded != allowed:
        raise AssertionError(f"the fresh process imported {loaded}")
    fresh_diff = float(np.abs(np.load(os.path.join(root, "verts.npy")) - want["generated_verts"][:64]).max())
    if not fresh_diff <= 1e-5:
        raise AssertionError(f"the fresh process's verts are {fresh_diff:.3e} from the live Predictor's")
    print(
        f"[export] export_predictor ResNet-50 224px bf16 batch 64, platforms {meta['platforms']}: {nbytes} bytes, "
        f"{export_s:.1f} s to export, {load_s:.1f} s to load on cuda | ExportedPredictor vs Predictor over 64 + 37 "
        f"images: max {diff:.3e} (atol 1e-5){', bit-equal' if bit_equal else ''} | {len(timed) / np.median(t_art):.1f} "
        f"img/s against the live {len(timed) / np.median(t_live):.1f} (median of 6 alternated runs of {len(timed)}; "
        f"artifact {len(timed) / max(t_art):.1f}-{len(timed) / min(t_art):.1f}, live {len(timed) / max(t_live):.1f}-"
        f"{len(timed) / min(t_live):.1f}) "
        f"| int8 artifact (cuda, {os.path.getsize(path8)} bytes, {export8_s:.1f} s): max {diff8:.3e} from the live "
        f"int8 Predictor (atol 5e-3) | a fresh process ({fresh_s:.1f} s) loaded it with {loaded} and matched "
        f"(max {fresh_diff:.3e}) | on {card}",
        flush=True,
    )


# ---------------------------------------------------------------------------
# [data-parallel]: the step over ranks, in child processes (this process never
# initializes a process group)

DP_DIR = os.path.join(SMOKE_DIR, "dp")
DP_CHILD_TIMEOUT = 420  # seconds per child run: a hung rendezvous fails the phase


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(part: str, world: int):
    """``python chip_smoke.py --dp-child PART`` as ``world`` ranks with
    torchrun's environment; each child's last stdout line is its JSON
    result. A child that fails or outlives the timeout fails the phase."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        for var in ("NCCL_SOCKET_IFNAME", "GLOO_SOCKET_IFNAME"):  # the loopback: no network here
            env.setdefault(var, "lo")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-child", part], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_CHILD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[data-parallel] ({part}) rank {r} exited {p.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


class _OneProcess:
    """The one-process path while a process group is up: ``parallel.mesh``
    reports no group inside the block (the plain step of ``[data-parallel]``
    (a), on the same inputs in the same process)."""

    def __init__(self, pmesh):
        self.pmesh = pmesh

    def __enter__(self):
        self.real = self.pmesh.is_distributed
        self.pmesh.is_distributed = lambda: False

    def __exit__(self, *exc):
        self.pmesh.is_distributed = self.real


def _tensor_digest(torch, tensors) -> str:
    """sha256 of the tensors' bytes in name order (ranks that must hold the
    same state compare digests)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_child_a(torch, cc):
    """One rank on NCCL at ``[train]``'s full width: the data-parallel
    make_train_step and the plain step (the group hidden) one step each
    from equal states on the same batch and generator seed (new states
    compared), then alternated for timing; the NCCL all-reduce's device ms
    per step (profiler); a data-parallel Predictor batch of 64 against the
    plain one."""
    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.infer.predictor import Predictor
    from human_pose_estimation_tpu_torch.models.port_jax import mean_theta as to_mean_theta
    from human_pose_estimation_tpu_torch.parallel import mesh as pmesh
    from human_pose_estimation_tpu_torch.train.state import create_train_state
    from human_pose_estimation_tpu_torch.train.step import make_train_step
    from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

    pmesh.maybe_initialize_distributed("cuda")
    backend = torch.distributed.get_backend()
    if backend != "nccl" or pmesh.world_size() != 1:
        raise AssertionError(f"expected a world-1 NCCL group, got {backend} x {pmesh.world_size()}")
    smpl = synthetic_model(num_verts=6890, seed=0)
    mean_theta = to_mean_theta(synthetic_mean_params())
    n, img, p, rounds = 8, 224, 16384, 5
    cfg = Config(batch_size=n, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
                 mr_metric_stages="all", max_silhouette_points=p, use_gradient_penalty=True)
    dp_state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    with _OneProcess(pmesh):
        plain_state = create_train_state(smpl, mean_theta, cfg, device="cuda", seed=0)
    step = make_train_step(cfg, device="cuda")
    batches = _train_batches(torch, smpl, n, p, img, rounds + 1, seed=2, device="cuda")
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731

    launches = {"LAUNCHES": 0, "VALUE_GRAD_LAUNCHES": 0}

    def dp_step(batch, mocap, g):
        k1, k2 = cc.LAUNCHES, cc.VALUE_GRAD_LAUNCHES
        m = step(dp_state, batch, mocap, g)
        torch.cuda.synchronize()
        launches["LAUNCHES"] += cc.LAUNCHES - k1
        launches["VALUE_GRAD_LAUNCHES"] += cc.VALUE_GRAD_LAUNCHES - k2
        return m

    def plain_step(batch, mocap, g):
        with _OneProcess(pmesh):
            m = step(plain_state, batch, mocap, g)
        torch.cuda.synchronize()
        return m

    # the check: one step each from equal states, same batch, same seed
    m_plain, m_dp = plain_step(*batches[0], gen()), dp_step(*batches[0], gen())
    got, want = _state_tensors(dp_state), _state_tensors(plain_state)
    equal = all(torch.equal(got[k], w) for k, w in want.items()) and all(
        torch.equal(getattr(m_dp, f), getattr(m_plain, f)) for f in vars(m_plain))
    state_rel, state_leaf = _max_rel(torch, got, want)
    metric_rel = max(float((getattr(m_dp, f).double() - v.double()).abs().max()) / max(float(v.abs().max()), 1e-30)
                     for f, v in vars(m_plain).items())
    if not equal and (state_rel > 1e-6 or metric_rel > 1e-6):
        raise AssertionError(f"world-1 step vs plain: state {state_rel:.2e} ({state_leaf}), metrics {metric_rel:.2e}")

    # timing: the two steps alternated, each on its own state
    plain_ms, dp_ms = [], []
    for batch, mocap in batches[1:]:
        for fn, times in ((plain_step, plain_ms), (dp_step, dp_ms)):
            t0 = time.perf_counter()
            fn(batch, mocap, gen())
            times.append(1e3 * (time.perf_counter() - t0))
    # under the profiler, 2 steps of each: device time, the NCCL kernels'
    # device time, and the collectives' calls and host time
    from torch.profiler import ProfilerActivity, profile

    profiled = {}
    for name, fn in (("plain", plain_step), ("dp", dp_step)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for batch, mocap in batches[1:3]:
                fn(batch, mocap, gen())
        events = prof.key_averages()
        rows = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
        nccl = [e for e in rows if "nccl" in e.key.lower()]
        calls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key.startswith(("nccl:", "c10d::allreduce", "c10d::broadcast"))]
        profiled[name] = {
            "device_ms": sum(e.self_device_time_total for e in rows) / 1e3 / 2,
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3 / 2,
            "nccl_launches": sum(e.count for e in nccl) / 2,
            "collectives": {e.key: (e.count / 2, e.cpu_time_total / 1e3 / 2) for e in calls},
            "rows": {e.key: (e.count / 2, e.self_device_time_total / 1e3 / 2) for e in rows},
        }

    def plain_unsynced():
        with _OneProcess(pmesh):
            step(plain_state, *batches[1], gen())

    syncs = {"plain": _host_syncs(torch, plain_unsynced),
             "dp": _host_syncs(torch, lambda: step(dp_state, *batches[1], gen()))}

    # serving: a data-parallel Predictor (one replica per local card) against the plain one
    variables, mean = dp_state.hmr.state_dict(), dp_state.mean_theta.detach()
    pcfg = Config(batch_size=64, img_size=img, encoder_dtype="bfloat16")
    dp_pred = Predictor(pcfg, smpl=smpl, variables=variables, mean_theta=mean, data_parallel=True, device="cuda")
    plain_pred = Predictor(pcfg, smpl=smpl, variables=variables, mean_theta=mean, device="cuda")
    images = np.random.RandomState(21).randint(0, 256, size=(64, img, img, 3)).astype("uint8")
    a, b = dp_pred.predict(images), plain_pred.predict(images)
    pred_err = max(float(np.abs(a[k] - b[k]).max()) for k in b)
    if pred_err > 1e-5:
        raise AssertionError(f"data-parallel Predictor vs plain: max abs {pred_err:.3e} > 1e-5")
    torch.distributed.destroy_process_group()
    return {
        "bit_equal": bool(equal), "state_rel": state_rel, "metric_rel": metric_rel,
        "plain_ms": float(np.median(plain_ms)), "dp_ms": float(np.median(dp_ms)), "rounds": rounds,
        "profiled": profiled, "syncs": syncs,
        "replicas": len(dp_pred.replicas), "pred_err": pred_err, "launches": launches,
    }


def _dp_child_b(torch, cc):
    """One of two ranks sharing the card over gloo (NCCL refuses two ranks
    on one device): the f64 step at ``[train-parity]``'s configuration on
    this rank's 4 of 8 rows (results to DP_DIR for the parent's check
    against one process), then a full-width Trainer for 3 steps with a
    checkpoint by rank 0, restored on both ranks, and a
    ``validate_checkpoint`` sweep of global means."""
    import contextlib
    import io

    import numpy as np

    from human_pose_estimation_tpu_torch.config import Config
    from human_pose_estimation_tpu_torch.data.npz_dataset import NpzMocapPipeline
    from human_pose_estimation_tpu_torch.models.port_jax import mean_theta as to_mean_theta
    from human_pose_estimation_tpu_torch.parallel import mesh as pmesh
    from human_pose_estimation_tpu_torch.train.step import GenBatch, MocapBatch
    from human_pose_estimation_tpu_torch.train.trainer import Trainer
    from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                                         world_size=int(os.environ["WORLD_SIZE"]))
    if not pmesh.maybe_initialize_distributed("cuda") or torch.distributed.get_backend() != "gloo":
        raise AssertionError("expected the caller's 2-rank gloo group to stay")
    rank = pmesh.rank()
    smpl = synthetic_model(num_verts=6890, seed=0)
    mean_theta = to_mean_theta(synthetic_mean_params())

    # (b1) the f64 step on this rank's rows of [train-parity]'s batch of 8
    n, img, p = 8, 224, 2048
    cfg = Config(batch_size=n // 2, img_size=img, encoder_dtype="float32", use_mesh_repro_loss=True)
    (batch, mocap), = _train_batches(torch, smpl, n, p, img, 1, seed=3, device="cpu")
    batch = GenBatch(*(pmesh.local_rows(t) for t in batch))
    mocap = MocapBatch(*(pmesh.local_rows(t, cfg.num_stage) for t in mocap))
    t0 = time.perf_counter()
    torch.save(_parity_step(torch, smpl, mean_theta, cfg, batch, mocap, "cuda", torch.float64),
               os.path.join(DP_DIR, f"f64_rank{rank}.pt"))
    f64_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # (b2) the Trainer at full width: batch 4 per rank (8 global), 3 steps
    n, p = 8, 16384
    launches = {"LAUNCHES": 0, "VALUE_GRAD_LAUNCHES": 0}
    k1, k2 = cc.LAUNCHES, cc.VALUE_GRAD_LAUNCHES
    tcfg = Config(batch_size=n // 2, img_size=img, encoder_dtype="bfloat16", use_mesh_repro_loss=True,
                  mr_metric_stages="all", max_silhouette_points=p, use_gradient_penalty=True,
                  num_examples_override=3 * n, epoch=1, checkpoint_every_epochs=1, validation_step_size=3,
                  log_img_step=0, model_dir=None, checkpoint_dir=os.path.join(DP_DIR, "ckpt"))
    pairs = _train_batches(torch, smpl, n, p, img, 3, seed=6, device="cuda")
    images = [(GenBatch(*(pmesh.local_rows(t) for t in b)), n // 2) for b, _ in pairs]
    val = [(GenBatch(*(pmesh.local_rows(t) for t in b)), n // 2)
           for b in _eval_batches(torch, torch.Generator().manual_seed(8), n, p, img, 2)]
    mocap = NpzMocapPipeline(tcfg, smpl, [MOCAP_SHARD], device_forward=True, seed=3, device="cuda")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trainer = Trainer(tcfg, dataset=images, mocap_dataset=mocap, val_dataset=val, smpl=smpl, device="cuda")
        step_ms, inner = [], trainer.train_step

        def timed(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = inner(*a)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            return m

        trainer.train_step = timed
        history = trainer.train()
        trained = _state_tensors(trainer.state)
        fresh = Trainer(tcfg, dataset=[], val_dataset=val, smpl=smpl, device="cuda")
        restored_step = fresh.restore()
        results = fresh.validate_checkpoint(restore=False)
    launches["LAUNCHES"] += cc.LAUNCHES - k1
    launches["VALUE_GRAD_LAUNCHES"] += cc.VALUE_GRAD_LAUNCHES - k2
    restored = _state_tensors(fresh.state)
    restore_equal = all(torch.equal(restored[k], v) for k, v in trained.items())
    if not restore_equal or restored_step != 3:
        raise AssertionError(f"rank {rank}: restore at step {restored_step}, bit-equal {restore_equal}")
    for key in ("kpr", "mr", "critic"):
        if len(history[key]) != 3 or not np.isfinite(history[key]).all():
            raise AssertionError(f"rank {rank}: {key} history {history[key]}")
    torch.distributed.destroy_process_group()
    return {
        "rank": rank, "f64_s": f64_s, "step_ms": step_ms, "digest": _tensor_digest(torch, trained),
        "history": history, "validate": {k: results[k] for k in ("mean_kpr_loss", "mean_mr_loss", "pck@0.5")},
        "ckpt": sorted(os.listdir(tcfg.checkpoint_dir)), "launches": launches,
    }


def _dp_child(part: str) -> int:
    """Entry of a ``[data-parallel]`` child: prints its result as one JSON line."""
    import torch

    sys.path.insert(0, HERE)
    from human_pose_estimation_tpu_torch import pin_f32_numerics
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    pin_f32_numerics()
    cc.build_all()  # loads the parent's build from build/kernels
    result = (_dp_child_a if part == "a" else _dp_child_b)(torch, cc)
    print(json.dumps(result), flush=True)
    return 0


def phase_data_parallel(torch, cc, card, smpl, mean_theta):
    """``[data-parallel]``: (a) one rank on NCCL at ``[train]``'s full width,
    the data-parallel step against the plain one; (b) two ranks sharing the
    card over gloo: the f64 step on 4 rows each against one process on the
    8 (checked here, 1e-9), and a 2-rank Trainer with checkpoint and
    restore. Returns the children's K1 / K2 launches on their main paths
    (the data-parallel steps, the Trainer and its validation)."""
    import shutil

    from human_pose_estimation_tpu_torch.config import Config

    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (a,) = _run_children("a", 1)
    a_s = time.perf_counter() - t0
    dp, pl = a["profiled"]["dp"], a["profiled"]["plain"]
    collectives = ", ".join(f"{k} {c:.0f} {ms:.2f}" for k, (c, ms) in sorted(dp["collectives"].items()))
    # the device rows the data-parallel step grew most (where a world-1 NCCL group spends its device time)
    grown = sorted(
        ((dp["rows"][k][1] - pl["rows"].get(k, (0, 0.0))[1], dp["rows"][k][0] - pl["rows"].get(k, (0, 0.0))[0], k)
         for k in dp["rows"]), reverse=True)[:3]
    grown = ", ".join(f"{k[:40]} +{ms:.3f} ms in {n:+.0f} launches" for ms, n, k in grown)
    print(
        f"[data-parallel] (a) 1 rank, NCCL, make_train_step ResNet-50 224px bf16 batch 8 P=16384 mr on 3 stages, "
        f"GP on, mocap 24: new state vs the plain step (same inputs, same seed) "
        f"{'bit-equal' if a['bit_equal'] else 'state max rel %.2e, metrics %.2e (limit 1e-6)' % (a['state_rel'], a['metric_rel'])} "
        f"| alternated, median of {a['rounds']}: plain {a['plain_ms']:.2f} ms/step, data-parallel "
        f"{a['dp_ms']:.2f} ms/step | profiler, per step: NCCL kernels {dp['nccl_ms']:.3f} ms of device time in "
        f"{dp['nccl_launches']:.0f} launches; device time {dp['device_ms']:.3f} ms against plain "
        f"{pl['device_ms']:.3f} ms, grown most: {grown}; collectives (calls, host ms) {collectives} | host syncs per step: plain "
        f"{a['syncs']['plain']}, data-parallel {a['syncs']['dp']} "
        f"| Predictor(data_parallel=True) batch 64 on {a['replicas']} replica(s) vs plain: max abs "
        f"{a['pred_err']:.2e} (atol 1e-5) | K1/K2 launches {a['launches']} | child {a_s:.1f} s | {card}",
        flush=True,
    )

    t0 = time.perf_counter()
    b = _run_children("b", 2)
    b_s = time.perf_counter() - t0
    n, img, p = 8, 224, 2048
    (batch, mocap), = _train_batches(torch, smpl, n, p, img, 1, seed=3, device="cpu")
    cfg = Config(batch_size=n, img_size=img, encoder_dtype="float32", use_mesh_repro_loss=True)
    one = _parity_step(torch, smpl, mean_theta, cfg, batch, mocap, "cuda", torch.float64)
    worst = {}
    for r in range(2):
        got = torch.load(os.path.join(DP_DIR, f"f64_rank{r}.pt"))
        m_rel = {f: float((got[0][f] - v).abs().max()) / max(float(v.abs().max()), 1e-30) for f, v in one[0].items()}
        _, g_rel, leaf = _worst(got, one)
        s_rel, s_leaf = _max_rel(torch, got[2], one[2])
        worst[r] = (max(v for f, v in m_rel.items() if f != "mr_losses"), m_rel["mr_losses"], g_rel, leaf, s_rel, s_leaf)
        if not (worst[r][0] <= 1e-9 and worst[r][1] <= 1e-6 and g_rel <= 1e-9 and s_rel <= 1e-9):
            raise AssertionError(f"[data-parallel] (b) rank {r} f64 step vs one process: {worst[r]}")
    if b[0]["digest"] != b[1]["digest"] or b[0]["history"] != b[1]["history"] or b[0]["validate"] != b[1]["validate"]:
        raise AssertionError("[data-parallel] (b) the ranks' trained states, histories or sweeps differ")
    if b[0]["ckpt"] != ["3"]:
        raise AssertionError(f"[data-parallel] (b) checkpoint steps {b[0]['ckpt']}, expected ['3']")
    w = max(worst.values())
    print(
        f"[data-parallel] (b) 2 ranks on one card over gloo (NCCL refuses two ranks on one device): f64 "
        f"make_train_step ResNet-50 224px P=2048, 4 rows per rank (K2) vs one process on 8: StepMetrics max rel "
        f"{w[0]:.2e} (mr_losses {w[1]:.2e}: the chamfer sums in f32), gradients {w[2]:.2e} ({w[3]}), BN statistics "
        f"{w[4]:.2e}; limit 1e-9 (mr 1e-6) | f64 step {b[0]['f64_s']:.1f} s on rank 0 | Trainer ResNet-50 224px "
        f"bf16 batch 4 per rank, P=16384, 3 steps: ms per step rank 0 "
        f"{', '.join(f'{t:.1f}' for t in b[0]['step_ms'])}, rank 1 {', '.join(f'{t:.1f}' for t in b[1]['step_ms'])}; "
        f"states equal across ranks (sha256), checkpoint by rank 0 at step 3, restored bit-equal on both; "
        f"validate_checkpoint {b[0]['validate']} on both | K1/K2 launches per rank {b[0]['launches']} | "
        f"children {b_s:.1f} s | {card}",
        flush=True,
    )
    return {name: a["launches"][name] + sum(r["launches"][name] for r in b) for name in a["launches"]}


def main() -> int:
    if sys.argv[1:2] == ["--dp-child"]:
        return _dp_child(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "human_pose_estimation_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np

    from human_pose_estimation_tpu_torch import pin_f32_numerics
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    pin_f32_numerics()
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {kind} | {card}", flush=True)

    t0 = time.perf_counter()
    cc.build_all()  # one nvcc per source, started together
    built = ", ".join(f"{k}.cu {v:.2f} s" for k, v in sorted(cc.BUILD_SECONDS.items()))
    print(
        f"[build] nvcc (in parallel) {built or 'cached'}, wall {time.perf_counter() - t0:.2f} s | "
        f"{_ptxas_summary(chr(10).join(cc.BUILD_LOG.values()))}",
        flush=True,
    )

    k1 = phase_kernel(torch, cc, card)
    k2, k3, k4 = phase_kernel_bwd(torch, cc, card)

    from human_pose_estimation_tpu_torch.models.port_jax import mean_theta as to_mean_theta
    from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

    smpl = synthetic_model(num_verts=6890, seed=0)
    mean_theta = to_mean_theta(synthetic_mean_params())
    counters = {"LAUNCHES": k1, "VALUE_GRAD_LAUNCHES": k2, "GRAD_LAUNCHES": k3, "F32IDX_LAUNCHES": k4}

    def counted(*phases):
        """Run the phases with every kernel's count set to 0 before and
        added to its kernel's launches after."""
        for name in counters:
            setattr(cc, name, 0)
        for phase, *args in phases:
            phase(*args)
        for name, entry in counters.items():
            entry["launches"] = entry.get("launches", 0) + getattr(cc, name)

    # the main path: serving, evaluation, training
    times = {}
    counted(
        (phase_serving, torch, card, smpl, mean_theta),
        (phase_eval, torch, cc, card, smpl, mean_theta),
        (lambda *a: times.setdefault("train", phase_train(*a)), torch, cc, card, smpl, mean_theta),
    )
    if k1["launches"] == 0 or k2["launches"] == 0:
        raise AssertionError("the main path never launched K1 or K2")

    # the on-device input path and the fused step from pinned host canvases
    hosts = _host_batches(torch, 12)
    mocap = _mocap_stream(torch, _fused_cfg(), smpl, samples=24 * 16)
    raws = [next(mocap) for _ in hosts]
    counted((phase_fused_train, torch, cc, card, smpl, mean_theta, hosts, raws))
    phase_augment_parity(torch, card, hosts[1])
    counted((phase_multi_step, torch, cc, card, smpl, mean_theta, hosts, raws))
    counted((phase_remat, torch, cc, card, smpl, mean_theta, hosts, raws))

    # the training loop, its checkpoints and validation sweep
    counted((phase_trainer, torch, cc, card, smpl, mean_theta, times["train"]))

    # the closed loop: rendered humans, the full hybrid recipe, quality against the generating parameters
    counted((phase_closed_loop, torch, cc, card))

    # the int8 encoder (its evaluation reads [trainer]'s checkpoint) and the serving stack
    int8 = phase_int8(torch, card, smpl, mean_theta)
    counted((phase_int8_eval, torch, cc, card, smpl, mean_theta))
    pred = _bf16_predictor(torch, smpl, mean_theta)
    images = np.random.RandomState(14).randint(0, 256, size=(640, 224, 224, 3)).astype("uint8")
    phase_batching(torch, card, pred, images)
    phase_http(torch, card, pred, images)
    phase_export(torch, card, pred, int8, images)
    del pred, int8

    # data parallelism in child processes: their main paths' K1 / K2 launches are added; the
    # parent's one-process f64 reference step is a comparison and stays out of the counts
    for name, n in phase_data_parallel(torch, cc, card, smpl, mean_theta).items():
        counters[name]["launches"] += n

    # the weight importers' TensorFlow-free halves at full width and the s2d stem
    counted((phase_weights, torch, cc, card, smpl, mean_theta))

    phase_train_parity(torch, card, smpl, mean_theta)

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
