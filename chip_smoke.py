#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the evaluation shape, then drives the
port's forward path at full width: the serving ``Predictor`` and the
evaluation ``make_val_step``. Every phase prints one line; any failure
raises and the script exits non-zero. The line before the last is a JSON
object with one entry per ported kernel; the last line is
``{"ok": true, "device": {...}}``.

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


def _time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ptxas_summary(log: str) -> str:
    """'kernel: N registers, B bytes smem, S spill stores' per entry
    function, from nvcc's -Xptxas -v output."""
    import re

    parts, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(gt_to_pred_kernel|pred_to_gt_kernel)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            parts.append(f"{name}: {m.group(1)} registers, {m.group(2)} B smem, {spills} B spilled")
            name = None
    return "; ".join(parts) or "ptxas output not found"


def _device_breakdown(torch, fn, wall_ms: float) -> str:
    """Summed CUDA kernel time of one call of ``fn`` under torch.profiler,
    against ``wall_ms`` (the same call timed without the profiler): the
    device's busy share, the three largest kernels and K1's share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not rows:
        return "device time not measured (the profiler saw no CUDA kernel)"
    busy = sum(r[1] for r in rows)
    k1 = sum(r[1] for r in rows if "gt_to_pred_kernel" in r[0] or "pred_to_gt_kernel" in r[0])
    top = sorted(rows, key=lambda r: -r[1])[:3]
    tops = ", ".join(f"{r[0][:48]} {r[1]:.3f} ms x{r[2]}" for r in top)
    return (
        f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[2] for r in rows)} kernel launches, K1 {k1:.3f} ms; top: {tops}"
    )


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


def phase_kernel(torch, cc, card):
    """K1 against its plain version on the card at the evaluation shape."""
    n, p, v, img = 8, 16384, 6890, 224
    gen = torch.Generator().manual_seed(0)
    # five prefix masks of 2k-9k pixels, then an empty mask, a non-prefix
    # mask (a prefix, an island and a lone last pixel) and an exact tie
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
    gt, mask, pred = gt.cuda(), mask.cuda(), pred.cuda()

    out = cc.chamfer_forward(gt, mask, pred)
    ref = cc.chamfer_forward_reference(gt, mask, pred)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rtol = 1e-5
    bad = err > rtol * ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K1 disagrees with its plain version: {out.tolist()} vs {ref.tolist()}")
    if float(out[5]) != 0.0:
        raise AssertionError(f"K1 on an empty mask gave {float(out[5])}, not 0")

    # the exact tie in isolation: L1 of the FIRST nearest vertex (7) plus
    # the two pred->gt distances (5 + 5)
    tie_gt = torch.zeros(1, 8, 2, device="cuda")
    tie_mask = torch.zeros(1, 8, device="cuda")
    tie_mask[0, 0] = 1.0
    tie_pred = torch.tensor([[[3.0, 4.0], [5.0, 0.0]]], device="cuda")
    tie = float(cc.chamfer_forward(tie_gt, tie_mask, tie_pred)[0])
    if tie != 17.0:
        raise AssertionError(f"K1 tie case gave {tie}, not 17")

    ms = _time_cuda(lambda: cc.chamfer_forward(gt, mask, pred), iters=100)
    plain_ms = _time_cuda(lambda: cc.chamfer_forward_reference(gt, mask, pred), iters=5, warmup=1)
    # yardstick: one library call for the pred->gt half (cdist + min over
    # the active pixels, masked pixels moved far away)
    pmax = int(cc.last_active(mask).max())
    gt_far = torch.where(mask[:, :pmax, None] > 0, gt[:, :pmax], torch.full_like(gt[:, :pmax], 1e6))
    library_ms = _time_cuda(lambda: torch.cdist(pred, gt_far).amin(dim=2), iters=20)

    valid = float(mask.sum())
    pairs = valid * v  # (valid pixel, vertex) pairs the function needs
    ops = 7 * pairs  # 5 for the shared distance, one min per direction
    nbytes = gt.numel() * 4 + mask.numel() * 4 + pred.numel() * 4 + n * 4
    bound_s = max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
    bound_by = "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    print(
        f"[kernel] K1 chamfer_fwd N={n} P={p} V={v} valid={int(valid)}: "
        f"max_abs_err={float(err.max()):.3e} (rtol {rtol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} cdist_ms={library_ms:.4f} bound_ms={bound_s * 1e3:.4f} "
        f"({bound_by}) on {card}",
        flush=True,
    )
    return {
        "name": "chamfer_fwd",
        "route": "cuda",
        "source": "human_pose_estimation_tpu_torch/csrc/chamfer_fwd.cu",
        "replaces": "human_pose_estimation_tpu/ops/pallas_chamfer.py:56",
        "max_abs_err": float(err.max()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


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
    from human_pose_estimation_tpu_torch.train.step import GenBatch, make_val_step

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

    batches = []
    for i in range(num_batches + 1):
        # 2k-9k pixels, mean ~4.5k: one large silhouette, the rest 2k-6.2k
        counts = torch.randint(2000, 6200, (n,), generator=gen).tolist()
        counts[0] = int(torch.randint(6200, 9200, (1,), generator=gen))
        pts, mask = _eval_silhouettes(gen, n, p, counts, img)
        kp = torch.rand(n, 19, 3, generator=gen) * 2 - 1
        kp[..., 2] = (torch.rand(n, 19, generator=gen) > 0.2).float()
        images = torch.rand(n, img, img, 3, generator=gen) * 2 - 1
        batches.append(GenBatch(images.cuda(), pts.cuda(), mask.cuda(), kp.cuda()))
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


def main() -> int:
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

    from human_pose_estimation_tpu_torch import pin_f32_numerics
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer as cc

    pin_f32_numerics()
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {kind} | {card}", flush=True)

    t0 = time.perf_counter()
    cc.build()
    built = cc.BUILD_SECONDS
    print(
        f"[build] chamfer_fwd.cu: nvcc {built if built is None else round(built, 2)} s, "
        f"load {time.perf_counter() - t0:.2f} s | {_ptxas_summary(cc.BUILD_LOG)}",
        flush=True,
    )

    k1 = phase_kernel(torch, cc, card)

    from human_pose_estimation_tpu_torch.models.port_jax import mean_theta as to_mean_theta
    from human_pose_estimation_tpu_torch.utils.assets import synthetic_mean_params, synthetic_model

    smpl = synthetic_model(num_verts=6890, seed=0)
    mean_theta = to_mean_theta(synthetic_mean_params())
    cc.LAUNCHES = 0  # the main path: serving, then evaluation
    phase_serving(torch, card, smpl, mean_theta)
    phase_eval(torch, cc, card, smpl, mean_theta)
    k1["launches"] = cc.LAUNCHES
    if k1["launches"] == 0:
        raise AssertionError("the main path never launched K1")

    print(card)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
