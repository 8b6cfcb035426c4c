"""Training state: the modules that hold the parameters and BN statistics,
the trainable mean theta, the two optimizers and the step (counterpart of
``human_pose_estimation_tpu/train/state.py``).

The JAX ``TrainState`` is one immutable pytree; here the modules are
updated in place by the optimizers, and ``make_train_step``'s step
function advances the state it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Tuple

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from ..config import Config
from ..models.critic import Critic
from ..models.hmr import HMR
from ..parallel import mesh as pmesh

__all__ = [
    "ADAM_EPS",
    "TrainState",
    "create_train_state",
    "gen_named_params",
    "make_optimizers",
    "step_generator",
]

# Keras Adam's default epsilon, which the reference's optimizers use and
# the JAX package passes to optax; torch's default is 1e-8.
ADAM_EPS = 1e-7


def lr_factor(schedule: str, decay_steps: int) -> Callable[[int], float]:
    """Multiplier of the base rate at update ``count`` (0 for the first
    update). 'cosine' is ``optax.cosine_decay_schedule(base, decay_steps)``
    with alpha 0: ``0.5 * (1 + cos(pi * min(count, decay_steps) /
    decay_steps))``."""
    if schedule == "constant":
        return lambda count: 1.0
    if schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("lr_schedule='cosine' requires lr_decay_steps > 0")
        return lambda count: 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    raise ValueError(f"unknown lr_schedule {schedule!r}")


def make_optimizers(
    gen_params: List[torch.Tensor],
    critic_params: List[torch.Tensor],
    generator_lr: float,
    critic_lr: float,
    lr_schedule: str = "constant",
    lr_decay_steps: int = 0,
) -> Tuple[torch.optim.Adam, LambdaLR, torch.optim.Adam, LambdaLR]:
    """The Adam pair of the generator and the critic (eps 1e-7), each with
    its schedule: ``(gen_opt, gen_sched, critic_opt, critic_sched)``. Step a
    scheduler after its optimizer, so that update ``k`` uses ``lr(k)``."""
    factor = lr_factor(lr_schedule, lr_decay_steps)
    gen_opt = torch.optim.Adam(gen_params, lr=generator_lr, eps=ADAM_EPS)
    critic_opt = torch.optim.Adam(critic_params, lr=critic_lr, eps=ADAM_EPS)
    return gen_opt, LambdaLR(gen_opt, factor), critic_opt, LambdaLR(critic_opt, factor)


def gen_named_params(hmr: HMR, mean_theta: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """The generator's parameters in the optimizer's order: the encoder,
    the regressor, then ``mean_theta``."""
    return list(hmr.named_parameters()) + [("mean_theta", mean_theta)]


def _set_update_count(sched: LambdaLR, count: int) -> None:
    """Put a scheduler where it stands after ``count`` updates."""
    sched.last_epoch = count
    for group, base, fn in zip(sched.optimizer.param_groups, sched.base_lrs, sched.lr_lambdas):
        group["lr"] = base * fn(count)
    sched._last_lr = [g["lr"] for g in sched.optimizer.param_groups]


def _adam_state(opt: torch.optim.Optimizer, named: List[Tuple[str, torch.Tensor]], count: int) -> Dict:
    """An Adam's moments keyed by parameter name (zeros before its first
    update) and its update count: the inverse of ``_load_adam``."""
    exp_avg, exp_avg_sq = {}, {}
    for name, p in named:
        st = opt.state.get(p, {})
        exp_avg[name] = st["exp_avg"].detach().clone() if "exp_avg" in st else torch.zeros_like(p.detach())
        exp_avg_sq[name] = st["exp_avg_sq"].detach().clone() if "exp_avg_sq" in st else torch.zeros_like(p.detach())
    return {"step": count, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


def _load_adam(opt: torch.optim.Optimizer, named: List[Tuple[str, torch.Tensor]], adam: Mapping) -> None:
    sd = opt.state_dict()
    sd["state"] = {
        i: {
            "step": torch.tensor(float(adam["step"])),
            "exp_avg": adam["exp_avg"][name],
            "exp_avg_sq": adam["exp_avg_sq"][name],
        }
        for i, (name, _) in enumerate(named)
    }
    opt.load_state_dict(sd)


@dataclasses.dataclass
class TrainState:
    hmr: HMR  # encoder + regressor parameters and BN statistics
    mean_theta: nn.Parameter  # (1, 85), trained with the generator
    critic: Critic
    gen_opt: torch.optim.Optimizer
    gen_sched: LambdaLR
    critic_opt: torch.optim.Optimizer
    critic_sched: LambdaLR
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.hmr.device

    def gen_params(self) -> List[torch.Tensor]:
        return [p for _, p in gen_named_params(self.hmr, self.mean_theta)]

    def load_state_dict(self, state: Mapping) -> None:
        """Load ``models.port_jax.train_state_from_jax``'s dict: weights,
        BN statistics, mean theta, critic, step, and both Adam states (their
        moments, update counts and the schedules' positions)."""
        self.hmr.load_state_dict(state["hmr"])
        self.critic.load_state_dict(state["critic"])
        with torch.no_grad():
            self.mean_theta.copy_(state["mean_theta"].reshape(self.mean_theta.shape))
        self.step = int(state["step"])
        named_critic = list(self.critic.named_parameters())
        for opt, sched, named, adam in (
            (self.gen_opt, self.gen_sched, gen_named_params(self.hmr, self.mean_theta), state["gen_adam"]),
            (self.critic_opt, self.critic_sched, named_critic, state["critic_adam"]),
        ):
            _load_adam(opt, named, adam)
            _set_update_count(sched, int(adam["step"]))

    def state_dict(self) -> Dict:
        """The inverse of ``load_state_dict``, in the layout of
        ``models.port_jax.train_state_from_jax``: ``step``, ``hmr`` (weights
        and BN statistics), ``mean_theta``, ``critic``, and ``gen_adam`` /
        ``critic_adam`` ({'step': the update count, which is also the
        schedule's position, 'exp_avg', 'exp_avg_sq'}). Tensors are copies,
        on the state's device."""
        named_critic = list(self.critic.named_parameters())
        return {
            "step": int(self.step),
            "hmr": {k: v.detach().clone() for k, v in self.hmr.state_dict().items()},
            "mean_theta": self.mean_theta.detach().clone(),
            "critic": {k: v.detach().clone() for k, v in self.critic.state_dict().items()},
            "gen_adam": _adam_state(
                self.gen_opt, gen_named_params(self.hmr, self.mean_theta), self.gen_sched.last_epoch
            ),
            "critic_adam": _adam_state(self.critic_opt, named_critic, self.critic_sched.last_epoch),
        }


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the dispatch that starts at ``step``: seeded from
    (``seed``, ``step``) alone, as the JAX loop folds its key on
    ``state.step``, so that a run resumed from a checkpoint draws what the
    straight run drew."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return gen


def create_train_state(smpl, mean_theta, cfg: Config, device=None, seed: int = 0) -> TrainState:
    """A fresh state from a seed: the HMR (``HMR.from_config``, with
    ``remat_encoder``) and the critic (scoring the rotations of the body
    model's joints) with the JAX package's initialisers, the mean theta as a trainable (1, 85) parameter, and the
    optimizers of ``make_optimizers``. Runs on ``cuda`` unless ``device``
    says otherwise. Under a process group every rank then holds rank 0's
    state (``parallel.mesh.replicate``)."""
    hmr = HMR.from_config(smpl, cfg, device=device, seed=seed, remat_encoder=cfg.remat_encoder)
    critic = Critic(rotation_joints=smpl.layout.num_joints - 1)
    critic.reset_parameters(torch.Generator().manual_seed(seed + 1))
    critic.to(hmr.device)
    mean = nn.Parameter(torch.as_tensor(mean_theta, dtype=torch.float32).reshape(1, -1).to(hmr.device).clone())
    gen_opt, gen_sched, critic_opt, critic_sched = make_optimizers(
        [p for _, p in gen_named_params(hmr, mean)],
        list(critic.parameters()),
        cfg.generator_lr,
        cfg.critic_lr,
        cfg.lr_schedule,
        cfg.lr_decay_steps,
    )
    state = TrainState(hmr, mean, critic, gen_opt, gen_sched, critic_opt, critic_sched)
    pmesh.replicate(state)
    return state

