"""The training window: ``Trainer.train`` on the fused path, as the
researcher's loop runs it.

Set-up builds one ``Trainer`` (fused step, no validation, image log,
checkpoint or profiler in reach), loads the benchmark's weights into its
state, and drives it through its first steps by the window's own call
(``Trainer.train``) on a pool of pinned uint8 canvases and raw mocap
batches: the first three are checked, then two more warm up. The window
then runs ``Trainer.train`` on the same object until ``--seconds`` have
passed: the feed ends the loop at the first step boundary after that. Every
step takes the next batch of the pool (all rows differ) and the next mocap
batch.

``correct``: the reference follows the first three steps from the same
weights, canvases, mocap and draws, in float32, and the run compares each
step's losses, the first gradient of every leaf as the optimizer holds it
after step 1 (Adam's first moment over 1 - beta1), and each leaf's change
after step 3 (``compare``). ``control`` gives the readings that the
limits were set from (``portbench/control.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench import harness as H
from portbench.glue import Feed, load_weights, program_body, program_config
from portbench import traffic
from portbench import weights as W
from portbench.compare import checks as compare_checks
from portbench.compare import f32, rel_gap
from portbench.reference import augment as ref_aug
from portbench.reference import train as ref_train

CHECKED = 3  # steps the reference follows
WARM = 2  # further warm-up steps before the window


def run(ctx: H.Ctx) -> H.Result:
    from human_pose_estimation_tpu_torch.train.step import HostBatch
    from human_pose_estimation_tpu_torch.train.trainer import Trainer

    cfg, tw, dev = ctx.config, ctx.workload["traffic"], ctx.device
    n = cfg["batch_size"]
    ctx.mark("imports")
    hmr_sd, mean = W.make_hmr(cfg, ctx.seed, dev)
    critic_sd = W.make_critic(cfg, ctx.seed, dev)
    body = W.make_body(cfg, ctx.seed, dev)
    host = traffic.canvases(traffic.rng(ctx.seed, 1), tw["pool_batches"], n, tw["canvas"])
    raw = traffic.mocap(traffic.rng(ctx.seed, 2), tw["pool_batches"], cfg["num_stage"] * n)
    pin = dev.type == "cuda"
    as_t = lambda a: torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)  # noqa: E731
    host_t = [HostBatch(*(as_t(h[k]) for k in ("image", "seg", "hw", "center", "label"))) for h in host]
    raw_t = [(as_t(p), as_t(s)) for p, s in raw]

    ctx.mark("weights and inputs")
    pcfg = program_config(cfg, ctx.seed)
    deadline = {"t": None}
    stop = lambda: deadline["t"] is not None and time.perf_counter() >= deadline["t"]  # noqa: E731

    def on_next(i):
        ctx.tracer.tick(steps=i, images=i * n)

    feed = Feed([(h, n) for h in host_t], stop, on_next)
    trainer = Trainer(pcfg, dataset=feed, mocap_dataset=Feed(raw_t), smpl=program_body(body, dev), device=dev)
    load_weights(trainer.state, hmr_sd, mean, critic_sd)
    ctx.mark("Trainer")

    # -- the first steps, through the window's own call
    init = {k: v.detach().cpu().clone() for k, v in _leaves(trainer.state).items()}
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
            first = _first_grads(trainer.state)
    after = {k: v.detach().cpu().clone() for k, v in _leaves(trainer.state).items()}
    ctx.mark("checked steps")
    trainer.train_step = step_fn
    for _ in range(WARM):
        trainer.train(max_steps=1)
    ctx.mark("warm steps")

    # -- the window
    k2_before = _k2_launches()
    start_i = feed.i
    ctx.open_window()
    deadline["t"] = ctx.t_window + ctx.seconds
    trainer.train()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    ctx.tracer.close(steps=feed.i, images=feed.i * n)
    done = feed.i - start_i
    k2 = _k2_launches() - k2_before
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"train_img_s": done * n / (t_end - ctx.t_window)}
    traced = None
    if ctx.tracer.summary() is not None:
        traced = (int(ctx.tracer.c_start["steps"]), int(ctx.tracer.c_stop["steps"]))
    del trainer, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference
    checks, notes = _check(ctx, cfg, hmr_sd, mean, critic_sd, body, host, raw, got, first, init, after)
    notes.update({"steps in the window": done, "K2 launches in the window": k2,
                  "K2 launches per step": (k2 / done) if done else None})
    if traced is not None:
        ctx.extra["chamfer_calls"] = _k2_work(cfg, host, ctx.seed, traced, dev)
    return H.Result(metrics, attempted=done, failed=0, checks=checks, memory_peak_bytes=peak, notes=notes)


def _k2_launches():
    from human_pose_estimation_tpu_torch.ops import cuda_chamfer

    return cuda_chamfer.VALUE_GRAD_LAUNCHES


def _leaves(state):
    """The optimizers' leaves by name: the generator's (encoder,
    regressor, mean theta) and the critic's (prefixed)."""
    out = {k: p for k, p in state.hmr.named_parameters()}
    out["mean_theta"] = state.mean_theta
    out.update({"critic." + k: p for k, p in state.critic.named_parameters()})
    return out


def _first_grads(state):
    """Each leaf's first gradient, from Adam's first moment after one
    update: m_1 = (1 - beta1) g."""
    out = {}
    for name, p in _leaves(state).items():
        opt = state.critic_opt if name.startswith("critic.") else state.gen_opt
        st = opt.state.get(p, {})
        m = st.get("exp_avg")
        beta1 = opt.param_groups[0]["betas"][0]
        out[name] = (m.detach().cpu() / (1.0 - beta1)) if m is not None else torch.zeros_like(p.detach().cpu())
    return out


def _ref_inputs(h, pool_dev):
    return {k: torch.from_numpy(h[k]).to(pool_dev) for k in ("image", "seg", "hw", "center", "label")}


def _check(ctx, cfg, hmr_sd, mean, critic_sd, body, host, raw, got, first, init, after):
    ref_steps, ref_first, ref_after = reference_steps(cfg, ctx.seed, hmr_sd, mean, critic_sd, body, host, raw,
                                                      ctx.device)
    return compare(ctx.workload["limits"], got, ref_steps, first, ref_first, init, after, ref_after)


def reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev, quant=None, rows=None):
    """The reference's first ``CHECKED`` steps from the benchmark's
    weights and inputs: (each step's losses, the first gradients, the
    leaves after the last step), leaves named as ``_leaves`` names them.
    ``quant`` and ``rows`` (the first rows of each batch only) serve the
    control and a planted fault."""
    with f32():
        bufs = {k: v.clone() for k, v in hmr_sd.items() if "running" in k}
        gen = {k: v.clone() for k, v in hmr_sd.items() if "running" not in k and "num_batches" not in k}
        gen["mean_theta"] = mean.clone()
        state = ref_train.State(gen, bufs, {k: v.clone() for k, v in critic_sd.items()},
                                ref_train.Adam(cfg["generator_lr"]), ref_train.Adam(cfg["critic_lr"]))
        ref_steps, ref_first = [], None
        rseed = int(seed) % (2**31) + 1
        for s in range(CHECKED):
            g = ref_train.step_generator(rseed, s, dev)
            h = _ref_inputs(host[s % len(host)], dev)
            p, sh = (torch.from_numpy(a).to(dev) for a in raw[s % len(raw)])
            if rows is not None:
                h = {k: v[:rows] for k, v in h.items()}
                p, sh = p[: rows * cfg["num_stage"]], sh[: rows * cfg["num_stage"]]
            out = ref_train.train_step(state, body, cfg, h, (p, sh), g, quant)
            ref_steps.append({k: v.cpu() for k, v in out.items() if not k.endswith("grads")})
            if s == 0:
                ref_first = {**{k: v.cpu() for k, v in out["gen_grads"].items()},
                             **{"critic." + k: v.cpu() for k, v in out["critic_grads"].items()}}
        ref_after = {**{k: v.cpu() for k, v in state.gen.items()},
                     **{"critic." + k: v.cpu() for k, v in state.critic.items()}}
    return ref_steps, ref_first, ref_after


def compare(limits, got, ref_steps, first, ref_first, init, after, ref_after):
    """The numbers of a training cell held against the reference (the cell's
    limits name those compared; the rest are printed), and notes.

    * ``loss_gap``: over the checked steps, the generator's and the
      critic's loss against the reference's, relative to the larger of the
      reference's two; ``loss1_gap``: the same at step 1 alone;
      ``mr1_gap``: step 1's silhouette loss at the first stage, relative.
    * ``grad1_gap`` / ``grad1_med``: the worst / the median leaf's gap of the
      first gradient's norm (``reference.train.leaf_gaps``).
    * ``change_gap`` / ``change_med``: the same of each leaf's change over
      the checked steps.

    Leaves whose reference gradient is nought to rounding (a bias before a
    BatchNorm) move under Adam by round-off alone: they are left out by a
    rule on the reference's first gradient, under 1e-3 of the median
    leaf's."""

    def loss_gaps(pairs):
        out = 0.0
        for p, r in pairs:
            scale = max(abs(float(r["generator_loss"])), abs(float(r["critic_loss"])), 1e-12)
            for k in ("generator_loss", "critic_loss"):
                out = max(out, abs(float(p[k]) - float(r[k])) / scale)
        return out

    inf = float("inf")
    whole = len(got) == len(ref_steps)
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_first.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    g = ref_train.leaf_gaps(first, ref_first, keep)
    d_prog = {k: after[k].double() - init[k].double() for k in keep}
    d_ref = {k: ref_after[k].double() - init[k].double() for k in keep}
    c = ref_train.leaf_gaps(d_prog, d_ref, keep)
    median = lambda d: float(torch.tensor(sorted(d.values())).median())  # noqa: E731
    numbers = {
        "loss_gap": loss_gaps(zip(got, ref_steps)) if whole else inf,
        "loss1_gap": loss_gaps(zip(got[:1], ref_steps[:1])) if got else inf,
        # step 1's silhouette loss at the first IEF stage (a sum over the
        # batch, before the last stage's dropout)
        "mr1_gap": rel_gap(got[0]["mr_losses"][0], ref_steps[0]["mr_losses"][0]) if got else inf,
        "grad1_gap": max(g.values()), "grad1_med": median(g),
        "change_gap": max(c.values()), "change_med": median(c),
    }
    notes = {
        "losses (program | reference) per step": [
            {k: (round(float(p[k]), 6), round(float(r[k]), 6)) for k in ("generator_loss", "critic_loss", "critic_penalty")}
            for p, r in zip(got, ref_steps)
        ],
        "stage losses at step 1 (program | reference)": {
            k: (got[0][k].tolist(), ref_steps[0][k].tolist()) for k in ("kpr_losses", "mr_losses", "gen_critic_losses")
        } if got else None,
        "all numbers": numbers,
        "grad1_gap leaf": max(g, key=g.get), "change_gap leaf": max(c, key=c.get),
        "leaves compared / left out": (len(keep), len(norms) - len(keep)),
    }
    return compare_checks(numbers, limits), notes


def control(cell: str, seed: int, dev, overrides=None) -> dict:
    """The float8 control, the half-batch fault and, beside them, the
    bfloat16-rounded reference (``portbench/control.py``), each held
    against the float32 reference as the program is and judged by the
    cell's limits."""
    _, cfg, wl = H.cell(H.benchmark(), cell)
    cfg.update(overrides or {})
    tw, n = wl["traffic"], cfg["batch_size"]
    hmr_sd, mean = W.make_hmr(cfg, seed, dev)
    critic_sd = W.make_critic(cfg, seed, dev)
    body = W.make_body(cfg, seed, dev)
    host = traffic.canvases(traffic.rng(seed, 1), tw["pool_batches"], n, tw["canvas"])
    raw = traffic.mocap(traffic.rng(seed, 2), tw["pool_batches"], cfg["num_stage"] * n)
    init = {**{k: v.cpu() for k, v in hmr_sd.items() if "running" not in k and "num_batches" not in k},
            "mean_theta": mean.cpu(), **{"critic." + k: v.cpu() for k, v in critic_sd.items()}}
    ref = reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev)
    out = {}
    for name, kw in (("control_fp8", {"quant": ref_train.fp8_quant}), ("fault_half_batch", {"rows": n // 2}),
                     ("bf16_simulated", {"quant": ref_train.bf16_round})):
        steps, first, after = reference_steps(cfg, seed, hmr_sd, mean, critic_sd, body, host, raw, dev, **kw)
        checks, notes = compare(wl["limits"], steps, ref[0], first, ref[1], init, after, ref[2])
        out[name] = {"correct": H.correct(checks, 0), **notes["all numbers"], "grad1_gap leaf": notes["grad1_gap leaf"]}
    return out


def _k2_work(cfg, host, seed, traced, dev):
    """The valid silhouette pixels of each K2 call of the traced steps,
    recomputed from the canvases and the steps' draws: (valid pixels, n)
    per call, ``num_stage`` calls per step."""
    work = []
    rseed = int(seed) % (2**31) + 1
    for s in range(traced[0], traced[1]):
        g = ref_train.step_generator(rseed, s, dev)
        prep = ref_aug.prepare(_ref_inputs(host[s % len(host)], dev), cfg, g, augment=True)
        valid = int(prep.seg_mask.sum())
        work.extend([(valid, prep.seg_mask.shape[0])] * cfg["num_stage"])
    return work
