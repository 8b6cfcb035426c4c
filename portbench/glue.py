"""The benchmark's side of the calls into the system under test: its
configuration built from a cell's configuration file, the body model and
weights handed over, and the feeds that stand in for the input streams."""
from __future__ import annotations

import torch


class Feed:
    """An endless iterator over a pool, which ends when ``stop()`` says
    so; one shared position across ``iter()`` calls, as a stream's."""

    def __init__(self, items, stop=None, on_next=None):
        self.items, self.i = items, 0
        self.stop, self.on_next = stop, on_next

    def __iter__(self):
        return self

    def __next__(self):
        if self.on_next is not None:
            self.on_next(self.i)
        if self.stop is not None and self.stop():
            raise StopIteration
        item = self.items[self.i % len(self.items)]
        self.i += 1
        return item


def program_config(cfg: dict, seed: int):
    from human_pose_estimation_tpu_torch.config import Config

    return Config(
        img_size=cfg["img_size"], batch_size=cfg["batch_size"], num_stage=cfg["num_stage"],
        encoder_dtype=cfg["encoder_dtype"], encoder_depth=cfg["encoder_depth"],
        encoder_stage_sizes=",".join(str(s) for s in cfg["encoder_stage_sizes"]) if cfg.get("shallow") else "",
        use_kpr_loss=cfg["use_kpr_loss"], use_mesh_repro_loss=cfg["use_mesh_repro_loss"],
        mr_metric_stages=cfg["mr_metric_stages"], use_gradient_penalty=True, gp_mode="reference",
        mr_scale_mode="reference", kpr_loss_weight=cfg["kpr_loss_weight"], mr_loss_weight=cfg["mr_loss_weight"],
        critic_loss_weight=cfg["critic_loss_weight"], cam_scale_hinge=cfg["cam_scale_hinge"],
        cam_scale_margin=cfg["cam_scale_margin"], generator_lr=cfg["generator_lr"], critic_lr=cfg["critic_lr"],
        lr_schedule="constant", trans_max=cfg["trans_max"], scale_min=cfg["scale_min"], scale_max=cfg["scale_max"],
        max_silhouette_points=cfg["max_silhouette_points"], fuse_preprocess=True, scalar_log_step=1,
        use_validation=False, log_img_step=0, epoch=10**9, num_examples_override=10**12,
        checkpoint_every_epochs=10**9, model_dir=None, profile_dir="", seed=int(seed) % (2**31),
        encoder_only=False, do_bone_evaluation=True, joint_type="lsp",
    )


def program_body(body, device):
    from human_pose_estimation_tpu_torch.core.smpl import SMPLModel

    return SMPLModel(*(t.clone() for t in body), faces=None).to(device)


def load_weights(state, hmr_sd, mean, critic_sd) -> None:
    state.hmr.load_state_dict(hmr_sd)
    state.critic.load_state_dict(critic_sd)
    with torch.no_grad():
        state.mean_theta.copy_(mean)

