"""The training window of HMR 2.0's model (the ViT-H backbone and the
transformer-decoder head): ``Trainer.train`` on the fused path, as
``drivers/train.py`` runs the ResNet HMR's, with the model chosen by the
program's configuration (``backbone='vit_h'``, ``head='transformer'``).

Set-up builds the program's configuration first, so that a program
without these keys fails here, before any weight is made. It then builds
one ``Trainer`` (fused step, no validation, image log, checkpoint or
profiler in reach), loads the benchmark's weights (``weights_hmr2.py``,
on the card) into its state, and drives it through its first steps by
``Trainer.train`` on a pool of pinned uint8 canvases and raw mocap
batches: the first three are checked, then two more warm up. The window
runs ``Trainer.train`` until ``--seconds`` have passed.

``correct``: the reference (``reference/hmr2.py``) follows the first three
steps from the same weights, canvases, mocap and draws, in float32 with
TF32 off, after the program's state is freed, and ``drivers/train.py``'s
``compare`` holds the program's losses, first gradients and changes
against it, on the card, with one number of its own: ``grad1_cos_med``,
the median leaf's 1 - cosine between the two first gradients. The
gradients are compared by direction there, not by norm: where the loss
has kinks (the keypoint L1's signs, the chamfer's nearest points),
rounding moves a leaf's norm at first order and its direction at second.

It compares each fused projection part by part (the q, k and v of a qkv,
the k and v of the cross-attention's kv): the key bias's gradient is
nought in exact arithmetic (softmax does not change when every score of
a query moves by the same amount), as are the q and k of the head's
self-attention over its one token, so those parts move under Adam by
round-off alone, by about the learning rate a step in bfloat16 and far
less in float32; ``compare``'s rule on the reference's first gradient
leaves them out, as it leaves out the ResNet's biases before a
BatchNorm. ``control`` gives the readings that the limits were set from.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench import harness as H
from portbench import traffic
from portbench import weights as W
from portbench import weights_hmr2 as WV
from portbench.compare import checks as compare_checks
from portbench.compare import f32
from portbench.glue import Feed, load_weights, program_body, program_config
from portbench.reference import hmr2 as ref_hmr2
from portbench.reference import train as ref_train

T = H.load_module("drivers", "train")  # its helpers: _leaves, _first_grads, compare, _k2_work
CHECKED = T.CHECKED
WARM = T.WARM
# fused projections: name suffix -> the parts stacked along the output axis
_FUSED = {"attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv", "self_qkv.weight": "qkv", "cross_kv.weight": "kv"}


def model_config(cfg: dict, seed: int):
    """The program's ``Config`` for the cell: ``glue.program_config``'s
    recipe (its ResNet depth key is not read by the ViT) with the model's
    keys; "" for the published widths, the smaller ones a test asks for."""
    vit = (cfg["vit_depth"], cfg["vit_width"], cfg["vit_heads"], cfg["vit_mlp"])
    head = (cfg["head_depth"], cfg["head_width"], cfg["head_heads"], cfg["head_dim_head"], cfg["head_mlp"])
    return program_config({"encoder_depth": 50, **cfg}, seed).replace(
        backbone=cfg["backbone"], head=cfg["head"],
        vit_shape="" if vit == (32, 1280, 16, 5120) else ",".join(map(str, vit)),
        head_shape="" if head == (6, 1024, 8, 64, 1024) else ",".join(map(str, head)),
    )


def _inputs(cfg: dict, tw: dict, seed: int, dev):
    n = cfg["batch_size"]
    hmr_sd, mean = WV.make_hmr2(cfg, seed, dev)
    critic_sd = W.make_critic(cfg, seed, dev)
    body = W.make_body(cfg, seed, dev)
    host = traffic.canvases(traffic.rng(seed, 1), tw["pool_batches"], n, tw["canvas"])
    raw = traffic.mocap(traffic.rng(seed, 2), tw["pool_batches"], cfg["num_stage"] * n)
    return hmr_sd, mean, critic_sd, body, host, raw


def _host(leaves) -> dict:
    return {k: v.detach().cpu().clone() for k, v in leaves.items()}


def _parts(leaves: dict, dev) -> dict:
    """The leaves on ``dev`` with each fused projection cut into its parts
    (``<name>.q``, ``.k``, ``.v``)."""
    out = {}
    for name, t in leaves.items():
        t = t.to(dev)
        tags = next((v for k, v in _FUSED.items() if name.endswith(k)), None)
        if tags is None:
            out[name] = t
        else:
            out.update({f"{name}.{tag}": part for tag, part in zip(tags, t.chunk(len(tags)))})
    return out


def _cos_med(first: dict, ref_first: dict) -> float:
    """The median leaf's 1 - cosine between the program's and the
    reference's first gradients, over the leaves that ``drivers/train.py``'s
    ``compare`` keeps (a reference norm of at least 1e-3 of the median
    leaf's)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_first.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    gaps = []
    for k in (k for k, v in norms.items() if v >= 1e-3 * med):
        a, b = first[k].double().flatten(), ref_first[k].double().flatten()
        gaps.append(1.0 - float(a @ b) / max(float(a.norm()) * norms[k], 1e-300))
    return float(torch.tensor(sorted(gaps)).median())


def compare(limits, got, ref, first, init, after):
    """``drivers/train.py``'s ``compare`` of the program's steps against the
    reference's (``reference_steps``) on the reference's device, part by
    part, with ``grad1_cos_med`` (``_cos_med``) among the numbers."""
    (ref_steps, ref_first, ref_after), dev = ref, next(iter(ref[1].values())).device
    first, ref_first = _parts(first, dev), _parts(ref_first, dev)
    own = {k: v for k, v in limits.items() if k == "grad1_cos_med"}
    checks, notes = T.compare({k: v for k, v in limits.items() if k not in own}, got, ref_steps, first, ref_first,
                              _parts(init, dev), _parts(after, dev), _parts(ref_after, dev))
    notes["all numbers"]["grad1_cos_med"] = _cos_med(first, ref_first)
    return checks + compare_checks(notes["all numbers"], own), notes


def run(ctx: H.Ctx) -> H.Result:
    from human_pose_estimation_tpu_torch.train.step import HostBatch
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    cfg, tw, dev = ctx.config, ctx.workload["traffic"], ctx.device
    n = cfg["batch_size"]
    pcfg = model_config(cfg, ctx.seed)
    ctx.mark("imports")
    hmr_sd, mean, critic_sd, body, host, raw = _inputs(cfg, tw, ctx.seed, dev)
    pin = dev.type == "cuda"
    as_t = lambda a: torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)  # noqa: E731
    host_t = [HostBatch(*(as_t(h[k]) for k in ("image", "seg", "hw", "center", "label"))) for h in host]
    raw_t = [(as_t(p), as_t(s)) for p, s in raw]
    ctx.mark("weights and inputs")

    deadline = {"t": None}
    stop = lambda: deadline["t"] is not None and time.perf_counter() >= deadline["t"]  # noqa: E731
    feed = Feed([(h, n) for h in host_t], stop, lambda i: ctx.tracer.tick(steps=i, images=i * n))
    trainer = Trainer(pcfg, dataset=feed, mocap_dataset=Feed(raw_t), smpl=program_body(body, dev), device=dev)
    load_weights(trainer.state, hmr_sd, mean, critic_sd)
    ctx.mark("Trainer")

    # -- the first steps, through the window's own call
    init = _host(T._leaves(trainer.state))
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
    after = _host(T._leaves(trainer.state))
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
    ctx.tracer.close(steps=feed.i, images=feed.i * n)
    done = feed.i - start_i
    peak = torch.cuda.max_memory_allocated(dev) if pin else 0
    metrics = {"train_img_s": done * n / (t_end - ctx.t_window)}
    traced = None
    if ctx.tracer.summary() is not None:
        traced = (int(ctx.tracer.c_start["steps"]), int(ctx.tracer.c_stop["steps"]))
    del trainer, feed, recording, step_fn
    gc.collect()
    if pin:
        torch.cuda.empty_cache()

    # -- the reference
    ref = reference_steps(cfg, ctx.seed, hmr_sd, mean, critic_sd, body, host, raw, dev)
    checks, notes = compare(ctx.workload["limits"], got, ref, first, init, after)
    notes["steps in the window"] = done
    if traced is not None:
        ctx.extra["chamfer_calls"] = T._k2_work(cfg, host, ctx.seed, traced, dev)
    return H.Result(metrics, attempted=done, failed=0, checks=checks, memory_peak_bytes=peak, notes=notes)


def reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev, quant=None, rows=None):
    """The reference's first ``CHECKED`` steps (``drivers/train.py``'s
    ``reference_steps`` on ``reference/hmr2.py``): (each step's losses on
    the host, the first gradients and the leaves after the last step on
    ``dev``)."""
    with f32():
        state = ref_hmr2.new_state(hmr_sd, mean, critic_sd, cfg)
        ref_steps, ref_first = [], None
        rseed = int(seed) % (2**31) + 1
        for s in range(CHECKED):
            g = ref_train.step_generator(rseed, s, dev)
            h = T._ref_inputs(host[s % len(host)], dev)
            p, sh = (torch.from_numpy(a).to(dev) for a in raw[s % len(raw)])
            if rows is not None:
                h = {k: v[:rows] for k, v in h.items()}
                p, sh = p[: rows * cfg["num_stage"]], sh[: rows * cfg["num_stage"]]
            out = ref_hmr2.train_step(state, body, cfg, h, (p, sh), g, quant)
            ref_steps.append({k: v.cpu() for k, v in out.items() if not k.endswith("grads")})
            if s == 0:
                ref_first = {**out["gen_grads"], **{"critic." + k: v for k, v in out["critic_grads"].items()}}
            del out
        ref_after = {**state.gen, **{"critic." + k: v for k, v in state.critic.items()}}
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref_steps, ref_first, ref_after


def control(cell: str, seed: int, dev, overrides=None) -> dict:
    """The float8 control, the half-batch fault, the state left unchanged
    and, beside them, the bfloat16-rounded reference
    (``portbench/control.py``), each held against the float32 reference as
    the program is and judged by the cell's limits."""
    _, cfg, wl = H.cell(H.benchmark(), cell)
    cfg.update(overrides or {})
    hmr_sd, mean, critic_sd, body, host, raw = _inputs(cfg, wl["traffic"], seed, dev)
    init = {**hmr_sd, "mean_theta": mean, **{"critic." + k: v for k, v in critic_sd.items()}}
    ref = reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev)
    out = {}
    for name, kw in (("control_fp8", {"quant": ref_train.fp8_quant}), ("fault_half_batch", {"rows": cfg["batch_size"] // 2}),
                     ("fault_state_unchanged", None), ("bf16_simulated", {"quant": ref_train.bf16_round})):
        steps, first, after = ref if kw is None else reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host,
                                                                     raw, dev, **kw)
        if kw is None:
            after = init  # the steps ran, the state was never written
        checks, notes = compare(wl["limits"], steps, ref, first, init, after)
        out[name] = {"correct": H.correct(checks, 0), **notes["all numbers"], "grad1_gap leaf": notes["grad1_gap leaf"]}
        del steps, first, after
    return out
