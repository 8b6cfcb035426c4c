"""The plain reference of the hybrid training step (Kanazawa et al. 2018,
with the report's silhouette chamfer and a KCS critic trained by WGAN-GP):

1. the input path on the step's draws (``augment.prepare``);
2. the real critic samples: the body model on the mocap (pose, shape),
   19 keypoints, the rotations without the root;
3. the generator: HMR in train mode (batch statistics, dropout on the
   last IEF stage), per-stage keypoint, silhouette and critic losses; its
   loss is the last stage's three terms plus the camera-scale hinge
   ``w * mean(relu(margin - s)^2)``; one Adam step;
4. the critic on the detached fakes of all stages against the mocap:
   ``sum(mean(fake - real))`` plus 10 x the gradient penalty on the
   per-element interpolates, with its double backward; one Adam step.

The step's random numbers come from one generator in this order: the
augmentation (``augment.draws``), the two dropout masks of the last
stage, then the penalty's uniforms for the fake joints, shapes and
rotations. Adam is written out (betas 0.9 and 0.999, eps 1e-7, the
bias-corrected step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from . import augment, losses, model

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-7


@dataclasses.dataclass
class Adam:
    lr: float
    t: int = 0
    m: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    v: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - BETA1**self.t, 1.0 - BETA2**self.t
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * BETA1 + (1.0 - BETA1) * g
            v = self.v.get(k, torch.zeros_like(g)) * BETA2 + (1.0 - BETA2) * g * g
            self.m[k], self.v[k] = m, v
            params[k] -= (self.lr / c1) * m / (v.sqrt() / c2**0.5 + ADAM_EPS)


@dataclasses.dataclass
class State:
    gen: Dict[str, torch.Tensor]  # encoder and regressor weights, "mean_theta"
    bufs: Dict[str, torch.Tensor]  # BatchNorm running statistics
    critic: Dict[str, torch.Tensor]
    gen_adam: Adam
    critic_adam: Adam


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: seeded from (seed, step) as the training loop
    seeds each of its steps, so that a resumed run draws what the straight
    run drew."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def stage_losses(stages, batch, cp, c, cfg: dict):
    kpr, mr, gc = [], [], []
    for s in stages:
        kpr.append(cfg["kpr_loss_weight"] * losses.keypoint_loss(batch.kp2d[:, : s.kp2d.shape[1]], s.kp2d))
        px = losses.to_pixels(s.verts, s.cam, float(cfg["img_size"]))
        mr.append(cfg["mr_loss_weight"] * losses.mesh_loss(batch.seg_points, batch.seg_mask, px))
        scores = model.critic(cp, model.kcs(s.joints, c), s.joints[:, :14], s.shape, s.rotations)
        gc.append(cfg["critic_loss_weight"] * -scores.mean(0).sum())
    return torch.stack(kpr), torch.stack(mr), torch.stack(gc)


def train_step(state: State, body: model.Body, cfg: dict, host: dict, mocap_raw, generator,
               quant: model.Quant = None) -> Dict[str, torch.Tensor]:
    """One hybrid step on ``state`` in place. Returns the step's losses and
    the generator's and critic's gradients (name -> tensor)."""
    stage_sizes = tuple(cfg["encoder_stage_sizes"])
    c = model.bone_matrix(host["image"].device)
    batch = augment.prepare(host, cfg, generator, augment=True)
    with torch.no_grad():
        pose, shape = mocap_raw
        _, real_j, real_rot = model.smpl(body, shape, pose, "cocoplus")
        real_j, real_rot = real_j[:, :14], real_rot[:, 1:]

    # ---- generator
    gen = {k: v.detach().requires_grad_() for k, v in state.gen.items()}
    stages = model.hmr(batch.images, gen["mean_theta"], gen, state.bufs, body, stage_sizes, cfg["num_stage"],
                       train=True, generator=generator, quant=quant)
    kpr, mr, gc = stage_losses(stages, batch, state.critic, c, cfg)
    hinge = cfg["cam_scale_hinge"] * torch.relu(cfg["cam_scale_margin"] - stages[-1].cam[:, 0]).square().mean()
    loss = kpr[-1] + mr[-1] + gc[-1] + hinge
    names = list(gen)
    g = torch.autograd.grad(loss, [gen[k] for k in names], allow_unused=True)
    gen_grads = {k: (torch.zeros_like(gen[k]) if gi is None else gi) for k, gi in zip(names, g)}
    state.gen_adam.step(state.gen, gen_grads)

    # ---- critic
    fake_j = torch.cat([s.joints[:, :14] for s in stages]).detach()
    fake_s = torch.cat([s.shape for s in stages]).detach()
    fake_r = torch.cat([s.rotations for s in stages]).detach()
    cp = {k: v.detach().requires_grad_() for k, v in state.critic.items()}
    real_out = model.critic(cp, model.kcs(real_j, c), real_j, shape, real_rot)
    fake_out = model.critic(cp, model.kcs(fake_j, c), fake_j, fake_s, fake_r)
    wgan = (fake_out - real_out).mean(0).sum()
    alpha = torch.rand(fake_j.shape, generator=generator, device=fake_j.device)
    beta = torch.rand(fake_s.shape, generator=generator, device=fake_j.device)
    gamma = torch.rand(fake_r.shape, generator=generator, device=fake_j.device)
    i_j = (fake_j + alpha * (real_j - fake_j)).detach()
    i_s = (fake_s + beta * (shape - fake_s)).detach()
    i_r = (fake_r + gamma * (real_rot - fake_r)).detach()
    i_k = model.kcs(i_j, c)
    inputs = [t.requires_grad_() for t in (i_k, i_j, i_s, i_r)]
    out = model.critic(cp, i_k, i_j[:, :14], i_s, i_r)
    penalty = losses.gradient_penalty(torch.autograd.grad(out.sum(), inputs, create_graph=True))
    c_loss = wgan + 10.0 * penalty
    cnames = list(cp)
    cg = torch.autograd.grad(c_loss, [cp[k] for k in cnames], allow_unused=True)
    critic_grads = {k: (torch.zeros_like(cp[k]) if gi is None else gi) for k, gi in zip(cnames, cg)}
    state.critic_adam.step(state.critic, critic_grads)
    return {
        "kpr_losses": kpr.detach(), "mr_losses": mr.detach(), "gen_critic_losses": gc.detach(),
        "generator_loss": loss.detach(), "critic_loss": c_loss.detach(), "critic_penalty": penalty.detach(),
        "gen_grads": gen_grads, "critic_grads": critic_grads,
    }


class _Round(torch.autograd.Function):
    """Rounds the value with ``fwd`` and the gradient that flows back
    through it with ``bwd``: a low-precision step's forward and backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _scaled(dtype: torch.dtype, top: float):
    """Per-tensor scaled rounding to a float8 format whose largest value is
    ``top``."""

    def rnd(x: torch.Tensor) -> torch.Tensor:
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).to(x.dtype) * scale

    return rnd


_E4M3, _E5M2 = _scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Rounding to bfloat16 (the configuration's own precision, simulated
    in float32 at the same points as ``fp8_quant``), both ways."""
    return _Round.apply(x, _to_bf16, _to_bf16)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Float8 training (the control's precision for a bfloat16
    computation): per-tensor scaled e4m3 on the way forward, e5m2 on the
    gradient's way back."""
    return _Round.apply(x, _E4M3, _E5M2)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names: List[str]) -> Dict[str, float]:
    """Per leaf, the gap between the norms: |(|a| - |b|)| over the larger of
    |b| and the median leaf's |b|."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(torch.tensor(sorted(rn.values())).median())
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k]) / max(rn[k], med, 1e-30) for k in names}
