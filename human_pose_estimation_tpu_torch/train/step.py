"""Evaluation step (counterpart of ``make_val_step`` and ``_stage_losses``
in ``human_pose_estimation_tpu/train/step.py``): the HMR forward with the
body model on every IEF stage, then per-stage keypoint, mesh-reprojection
and critic losses. The training step comes with the training slice."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..core.projection import reproject_to_pixels
from ..ops import kcs as K
from ..ops import losses as L


class GenBatch(NamedTuple):
    """One step of image data."""

    images: torch.Tensor  # (N, H, W, 3) in [-1, 1]
    seg_points: torch.Tensor  # (N, P, 2) padded silhouette pixel coords [x, y]
    seg_mask: torch.Tensor  # (N, P)
    kp2d: torch.Tensor  # (N, 19, 3) [x, y, vis] in [-1, 1]


def _stage_losses(stages, batch: GenBatch, critic, c_matrix, cfg: Config):
    """Per-stage (kpr, mr, critic) losses, each stacked to (num_stage,)."""
    kpr, mr, gcl = [], [], []
    zero = torch.zeros((), device=batch.kp2d.device)
    for i, s in enumerate(stages):
        # labels carry 19 cocoplus points; a 14-joint LSP head compares the
        # first 14 (the face points have zero visibility on LSP data)
        kp_gt = batch.kp2d[:, : s.kp2d.shape[1]]
        kpr.append(cfg.kpr_loss_weight * L.keypoint_reprojection_loss(kp_gt, s.kp2d))
        # mr_metric_stages='last' skips the early stages' chamfer entirely
        mr_wanted = cfg.mr_metric_stages == "all" or i == len(stages) - 1
        if cfg.use_mesh_repro_loss and mr_wanted:
            sil_pred = reproject_to_pixels(s.verts, s.cam, float(cfg.img_size))
            mr.append(
                cfg.mr_loss_weight
                * L.mesh_reprojection_loss(
                    batch.seg_points, batch.seg_mask, sil_pred, scale_mode=cfg.mr_scale_mode
                )
            )
        else:
            mr.append(zero)
        if not cfg.encoder_only:
            scores = critic(K.kcs(s.joints3d, c_matrix), s.joints3d[:, :14], s.shape, s.rotations)
            gcl.append(cfg.critic_loss_weight * -scores.mean(dim=0).sum())
        else:
            gcl.append(zero)
    return torch.stack(kpr), torch.stack(mr), torch.stack(gcl)


def make_val_step(hmr, critic, cfg: Config, return_stages: bool = False):
    """Build ``val_step(mean_theta, batch) -> dict`` for the HMR and critic
    modules (which hold their parameters) — evaluation forward + losses,
    no updates.

    return_stages=True also returns the per-stage keypoints / verts / cams
    stacked on a leading stage axis (for per-stage visualization).
    """
    c_matrix = torch.as_tensor(K.bone_incidence_matrix(), device=hmr.device)

    @torch.no_grad()
    def val_step(mean_theta: torch.Tensor, batch: GenBatch, encoder_qparams=None):
        stages = hmr(batch.images, mean_theta, smpl_stages="all", encoder_qparams=encoder_qparams)
        kpr, mr, gcl = _stage_losses(stages, batch, critic, c_matrix, cfg)
        last = stages[-1]
        out = dict(
            kpr_losses=kpr,
            mr_losses=mr,
            gen_critic_losses=gcl,
            pred_keypoints=last.kp2d,
            verts=last.verts,
            cams=last.cam,
        )
        if return_stages:
            out.update(
                stage_kp2d=torch.stack([s.kp2d for s in stages]),
                stage_verts=torch.stack([s.verts for s in stages]),
                stage_cams=torch.stack([s.cam for s in stages]),
            )
        return out

    return val_step
