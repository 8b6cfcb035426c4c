"""The training window of Multi-HMR's model (DINOv2's ViT-L/14 over the whole
image, the Human Prediction Head, SMPL-X) on whole images with person
slots: ``Trainer.train`` on the fused path, as ``drivers/train_hmr2.py``
runs HMR 2.0's, with the model chosen by the program's configuration
(``backbone='dinov2_l14'``, ``head='hph'``) and the person-slot layout by
the batches it is handed (``CrowdHostBatch``).

Set-up builds the program's configuration first and holds the program's
fixed choices (the pair among its families, the camera's field of view,
the ray bands, the ViT's stochastic depth) to the configuration file's, so
that a program without this model fails here, before any weight is made.
It then builds
one ``Trainer`` (fused step, no validation, image log, checkpoint or
profiler in reach), loads the benchmark's weights (``weights_mhmr.py``, on
the card) into its state, and drives it through its first steps by
``Trainer.train`` on a pool of pinned uint8 whole images with their
people (``traffic_crowd.py``) and raw SMPL-X mocap batches: the first
three are checked, then two more warm up. The window runs
``Trainer.train`` until ``--seconds`` have passed. The feed counts the
people in the steps it hands over (``persons``) beside the slots
(``person_slots``, the padded ones included); the traced window's counts
of both go to ``ctx.extra``, a step each.

``correct``: the reference (``reference/multihmr.py``) follows the first
three steps from the same weights, images, mocap and draws, in float32
with TF32 off, image by image, after the program's state is freed, and
``drivers/train_hmr2.py``'s ``compare`` holds the program's losses, first
gradients (part by part: the q, k and v of every fused projection) and
changes against it, on the card, with one number more: ``det1_gap``, step
1's detection loss against the reference's, relative. ``control`` gives
the readings that the limits were set from.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench import harness as H
from portbench import traffic_crowd as TC
from portbench import weights_mhmr as WM
from portbench.compare import checks as compare_checks
from portbench.compare import f32, rel_gap
from portbench.glue import Feed, load_weights, program_config
from portbench.reference import multihmr as ref_mhmr
from portbench.reference import train as ref_train

T = H.load_module("drivers", "train")  # its helpers: _leaves, _first_grads
V = H.load_module("drivers", "train_hmr2")  # its compare, part by part
CHECKED = T.CHECKED
WARM = T.WARM
_HOST = ("image", "seg", "center", "label", "present")


def model_config(cfg: dict, seed: int):
    """The program's ``Config`` for the cell: ``glue.program_config``'s
    recipe (its ResNet depth key is not read by the ViT) with the model's
    keys; "" for the published widths, the smaller ones a test asks for.
    Raises where the program lacks the model or fixes another camera, ray
    embedding or stochastic depth than the configuration file states."""
    from human_pose_estimation_tpu_torch.models.hmr import FAMILIES
    from human_pose_estimation_tpu_torch.models.transformer_head import FOV_DEG, RAY_BANDS
    from human_pose_estimation_tpu_torch.models.vit import DINOV2

    pair = (cfg["backbone"], cfg["head"])
    if pair not in FAMILIES:
        raise ValueError(f"the program has no model {pair}")
    fixed = {"fov_deg": FOV_DEG, "ray_bands": RAY_BANDS, "drop_path_rate": DINOV2.drop_path_rate}
    differ = {k: (v, cfg[k]) for k, v in fixed.items() if v != cfg[k]}
    if differ:
        raise ValueError(f"the program's fixed choices differ from the configuration's (program, file): {differ}")
    vit = (cfg["vit_depth"], cfg["vit_width"], cfg["vit_heads"], cfg["vit_mlp"])
    head = (cfg["head_depth"], cfg["head_width"], cfg["head_heads"], cfg["head_dim_head"], cfg["head_mlp"])
    return program_config({"encoder_depth": 50, **cfg}, seed).replace(
        backbone=cfg["backbone"], head=cfg["head"],
        vit_shape="" if vit == (24, 1024, 16, 4096) else ",".join(map(str, vit)),
        head_shape="" if head == (2, 1024, 8, 64, 1024) else ",".join(map(str, head)),
    )


def _inputs(cfg: dict, tw: dict, seed: int, dev):
    n = cfg["batch_size"]
    hmr_sd, mean = WM.make_mhmr(cfg, seed, dev)
    critic_sd = WM.make_critic(cfg, seed, dev)
    body = WM.make_body(cfg, seed, dev)
    host = TC.canvases(TC.rng(seed, 1), tw["pool_batches"], n, tw["canvas"], cfg["person_slots"], tw["min_height"],
                       tw["max_height"])
    raw = TC.mocap(TC.rng(seed, 2), tw["pool_batches"], cfg["num_stage"] * n * cfg["person_slots"])
    return hmr_sd, mean, critic_sd, body, host, raw


def compare(limits, got, ref, first, init, after):
    """``drivers/train_hmr2.py``'s ``compare``, with ``det1_gap`` among the
    numbers."""
    own = {k: v for k, v in limits.items() if k == "det1_gap"}
    checks, notes = V.compare({k: v for k, v in limits.items() if k not in own}, got, ref, first, init, after)
    ref_steps = ref[0]
    notes["all numbers"]["det1_gap"] = (rel_gap(got[0]["detection_loss"], ref_steps[0]["detection_loss"])
                                        if got else float("inf"))
    notes["detection loss at step 1 (program | reference)"] = (
        (float(got[0]["detection_loss"]), float(ref_steps[0]["detection_loss"])) if got else None)
    return checks + compare_checks(notes["all numbers"], own), notes


def run(ctx: H.Ctx) -> H.Result:
    from human_pose_estimation_tpu_torch.train.step import CrowdHostBatch
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    cfg, tw, dev = ctx.config, ctx.workload["traffic"], ctx.device
    n, k = cfg["batch_size"], cfg["person_slots"]
    pcfg = model_config(cfg, ctx.seed)
    ctx.mark("imports")
    hmr_sd, mean, critic_sd, body, host, raw = _inputs(cfg, tw, ctx.seed, dev)
    pin = dev.type == "cuda"
    as_t = lambda a: torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)  # noqa: E731
    host_t = [CrowdHostBatch(*(as_t(h[key]) for key in _HOST)) for h in host]
    raw_t = [(as_t(p), as_t(s)) for p, s in raw]
    people = [0]  # the people in the pool's first i batches, i = 0 .. pool
    for h in host:
        people.append(people[-1] + int(h["present"].sum()))
    persons = lambda i: (i // len(host)) * people[-1] + people[i % len(host)]  # noqa: E731  in the first i steps
    ctx.mark("weights and inputs")

    deadline = {"t": None}
    stop = lambda: deadline["t"] is not None and time.perf_counter() >= deadline["t"]  # noqa: E731

    def on_next(i):
        ctx.tracer.tick(steps=i, images=i * n, persons=persons(i), person_slots=i * n * k)

    feed = Feed([(h, n) for h in host_t], stop, on_next)
    trainer = Trainer(pcfg, dataset=feed, mocap_dataset=Feed(raw_t), smpl=WM.program_body(body, dev), device=dev)
    load_weights(trainer.state, hmr_sd, mean, critic_sd)
    ctx.mark("Trainer")

    # -- the first steps, through the window's own call
    init = V._host(T._leaves(trainer.state))
    got, step_fn = [], trainer.train_step

    def recording(*args):
        m = step_fn(*args)
        got.append({f.name: getattr(m, f.name).detach().cpu() for f in dataclasses.fields(m)})
        return m

    trainer.train_step = recording
    first = None
    for s in range(CHECKED):
        trainer.train(max_steps=1)
        if s == 0:
            first = T._first_grads(trainer.state)
    after = V._host(T._leaves(trainer.state))
    ctx.mark("checked steps")
    trainer.train_step = step_fn
    for _ in range(WARM):
        trainer.train(max_steps=1)
    ctx.mark("warm steps")

    # -- the window
    start_i = feed.i
    ctx.open_window()
    deadline["t"] = ctx.t_window + ctx.seconds
    trainer.train()
    if pin:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    done_i = feed.i
    ctx.tracer.close(steps=done_i, images=done_i * n, persons=persons(done_i), person_slots=done_i * n * k)
    done = done_i - start_i
    peak = torch.cuda.max_memory_allocated(dev) if pin else 0
    metrics = {"train_img_s": done * n / (t_end - ctx.t_window)}
    traced = None
    summary = ctx.tracer.summary()
    if summary is not None:
        traced = (int(ctx.tracer.c_start["steps"]), int(ctx.tracer.c_stop["steps"]))
        steps = max(summary.counts.get("steps", 0), 1)
        ctx.extra["persons"] = summary.counts.get("persons", 0) / steps
        ctx.extra["person_slots"] = summary.counts.get("person_slots", 0) / steps
    del trainer, feed, recording, step_fn
    gc.collect()
    if pin:
        torch.cuda.empty_cache()

    # -- the reference
    ref = reference_steps(cfg, ctx.seed, hmr_sd, mean, critic_sd, body, host, raw, dev)
    checks, notes = compare(ctx.workload["limits"], got, ref, first, init, after)
    notes["steps in the window"] = done
    notes["persons | slots a step (traced window)"] = (ctx.extra.get("persons"), ctx.extra.get("person_slots"))
    if traced is not None:
        ctx.extra["chamfer_calls"] = _k2_work(cfg, host, ctx.seed, traced, dev)
    return H.Result(metrics, attempted=done, failed=0, checks=checks, memory_peak_bytes=peak, notes=notes)


def _ref_inputs(h, dev):
    return {key: torch.from_numpy(h[key]).to(dev) for key in _HOST}


def reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev, quant=None, rows=None,
                    all_slots=False, det_per_image=False):
    """The reference's first ``CHECKED`` steps on ``reference/multihmr.py``:
    (each step's losses on the host, the first gradients and the leaves
    after the last step on ``dev``). ``rows``: the first images of each
    batch only, and their slots' mocap; ``all_slots``: every slot counted
    as a person at the image's centre (the padded slots' bookkeeping
    skipped); ``det_per_image``: the detection loss's mean taken per image
    and summed over the images."""
    with f32():
        state = ref_mhmr.new_state(hmr_sd, mean, critic_sd, cfg)
        ref_steps, ref_first = [], None
        rseed = int(seed) % (2**31) + 1
        per_image = cfg["num_stage"] * cfg["person_slots"]
        for s in range(CHECKED):
            g = ref_train.step_generator(rseed, s, dev)
            h = _ref_inputs(host[s % len(host)], dev)
            p, sh = (torch.from_numpy(a).to(dev) for a in raw[s % len(raw)])
            if rows is not None:
                h = {key: v[:rows] for key, v in h.items()}
                p, sh = p[: rows * per_image], sh[: rows * per_image]
            if all_slots:  # a padded slot as a person at the image's centre, with no keypoints or silhouette
                middle = torch.full_like(h["center"], h["image"].shape[1] // 2)
                h["center"] = torch.where(h["present"][..., None] > 0, h["center"], middle)
                h["present"] = torch.ones_like(h["present"])
            out = ref_mhmr.train_step(state, body, cfg, h, (p, sh), g, quant, det_per_image)
            ref_steps.append({key: v.cpu() for key, v in out.items() if not key.endswith("grads")})
            if s == 0:
                ref_first = {**out["gen_grads"], **{"critic." + key: v for key, v in out["critic_grads"].items()}}
            del out
        ref_after = {**state.gen, **{"critic." + key: v for key, v in state.critic.items()}}
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref_steps, ref_first, ref_after


def _k2_work(cfg, host, seed, traced, dev):
    """The valid silhouette pixels of each K2 call of the traced steps,
    recomputed from the images and the steps' draws: (valid pixels, slots)
    per call, one call a step."""
    work = []
    rseed = int(seed) % (2**31) + 1
    for s in range(traced[0], traced[1]):
        g = ref_train.step_generator(rseed, s, dev)
        prep = ref_mhmr.prepare(_ref_inputs(host[s % len(host)], dev), cfg, g)
        work.extend([(int(prep.seg_mask.sum()), prep.seg_mask.shape[0])] * cfg["num_stage"])
    return work


def control(cell: str, seed: int, dev, overrides=None) -> dict:
    """The float8 control, the half-batch fault, the state left unchanged,
    the padded slots counted as people, the detection loss's mean taken per
    image (the fault that ``det1_gap`` is there for: at the first step's
    weights the detection logits barely differ between patches, so a
    misplaced target moves the loss by some 1e-5 and only the loss's scale
    shows) and, beside them, the bfloat16-rounded reference
    (``portbench/control.py``), each held against the float32 reference as
    the program is and judged by the cell's limits."""
    _, cfg, wl = H.cell(H.benchmark(), cell)
    cfg.update(overrides or {})
    hmr_sd, mean, critic_sd, body, host, raw = _inputs(cfg, wl["traffic"], seed, dev)
    init = {**hmr_sd, "mean_theta": mean, **{"critic." + key: v for key, v in critic_sd.items()}}
    ref = reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev)
    out = {}
    for name, kw in (("control_fp8", {"quant": ref_train.fp8_quant}), ("fault_half_batch", {"rows": cfg["batch_size"] // 2}),
                     ("fault_state_unchanged", None), ("fault_padded_as_people", {"all_slots": True}),
                     ("fault_detection_per_image", {"det_per_image": True}),
                     ("bf16_simulated", {"quant": ref_train.bf16_round})):
        steps, first, after = ref if kw is None else reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host,
                                                                     raw, dev, **kw)
        if kw is None:
            after = init  # the steps ran, the state was never written
        checks, notes = compare(wl["limits"], steps, ref, first, init, after)
        out[name] = {"correct": H.correct(checks, 0), **notes["all numbers"], "grad1_gap leaf": notes["grad1_gap leaf"]}
        del steps, first, after
    return out
