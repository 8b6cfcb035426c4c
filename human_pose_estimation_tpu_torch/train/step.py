"""The training step and the evaluation step (counterpart of
``make_train_step``, ``make_val_step``, ``_stage_losses``,
``make_fused_train_step`` and ``make_multi_step`` in
``human_pose_estimation_tpu/train/step.py``).

The training step is the reference's hybrid step: the HMR forward with the
body model on every IEF stage and per-stage keypoint, mesh-reprojection
and critic losses; an Adam update of the generator (encoder, regressor,
mean theta) on the last stage's terms; then a WGAN-GP update of the critic
on the detached fakes of all three stages against real mocap, with the
penalty's double backward. The evaluation step is the same forward in
eval mode, without updates.

Under a process group (``parallel/mesh.py``) every step runs data-parallel:
each rank holds B rows, and the step over R ranks equals the one-process
step over the R x B rows up to the order of floating-point sums. The batch
statistics are global (BatchNorm's moments, the keypoint loss's count, the
batch means, the reference penalty's mean gradient), the random numbers
of the batch (dropout, penalty uniforms, the fused step's augmentation)
are drawn for the global batch and each rank keeps its rows, each
optimizer's gradients are summed in one flat all-reduce
(``parallel.mesh.all_reduce_grads`` says why the sum is exact), and the
returned metrics and losses are the global batch's on every rank. The
critic pairs fake row i with mocap row i of the same rank: a rank's mocap
batch holds the rows of the global one that ``parallel.mesh.row_index``
gives it (blocks of ``num_stage``).

The person-slot layout (a head whose ``takes_slots`` is set, Multi-HMR's
HPH; the fused step is handed ``CrowdHostBatch``es): each batch is B whole images with K person slots each (``SlotBatch``: the
per-slot labels and silhouettes, each slot's person centre and whether a
person fills it), and the model's rows are the B x K slots. The keypoint
loss counts the valid slots' visible keypoints only (a padded slot's are
hidden); the silhouette loss, the critic's scores, its WGAN margin and
the penalty's mean gradient are means over the valid slots (a padded
slot's weight is 0, so that what it holds changes nothing); and a
detection loss, the binary cross-entropy of the per-patch person logits
against the patches that hold a valid slot's centre, joins the
generator's loss (``gen.detect``). The means are the process's own: the
layout runs in one process.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config import Config
from ..models import body_graph
from ..ops import kcs as K
from ..ops import losses as L
from ..parallel import mesh as pmesh
from ..utils.tracing import span
from .state import TrainState


class GenBatch(NamedTuple):
    """One step of image data."""

    images: torch.Tensor  # (N, H, W, 3) in [-1, 1]
    seg_points: torch.Tensor  # (N, P, 2) padded silhouette pixel coords [x, y]
    seg_mask: torch.Tensor  # (N, P)
    kp2d: torch.Tensor  # (N, 19, 3) [x, y, vis] in [-1, 1]


class SlotBatch(NamedTuple):
    """One step of whole images with K person slots each (B images)."""

    images: torch.Tensor  # (B, H, W, 3) in [-1, 1]
    seg_points: torch.Tensor  # (B*K, P, 2) each slot's silhouette pixels [x, y]
    seg_mask: torch.Tensor  # (B*K, P), 0 in a padded slot
    kp2d: torch.Tensor  # (B*K, 19, 3) [x, y, vis] in [-1, 1], hidden in a padded slot
    centers: torch.Tensor  # (B, K, 2) each person's centre in pixels [x, y]
    valid: torch.Tensor  # (B, K) 1 where a person fills the slot

    @property
    def slots(self):
        """What the model takes: (centres, valid)."""
        return self.centers, self.valid


class CrowdHostBatch(NamedTuple):
    """Whole images with up to K people each, as a host pipeline hands
    them over (numpy arrays or (pinned) CPU tensors); the fused step copies
    them to the device and augments them there."""

    image: torch.Tensor  # (B, S, S, 3) uint8
    seg: torch.Tensor  # (B, S, S) uint8, bit k: slot k's silhouette
    center: torch.Tensor  # (B, K, 2) int32 each person's centre [x, y]
    label: torch.Tensor  # (B, K, 3, 19) keypoint rows [x, y, vis]
    present: torch.Tensor  # (B, K) uint8, 1 where a person fills the slot


class HostBatch(NamedTuple):
    """Raw decoded examples as the host pipeline produced them (fixed uint8
    canvases and their geometry), as numpy arrays or (pinned) CPU tensors;
    the fused training step copies them to the device and augments them
    there."""

    image: torch.Tensor  # (N, Hc, Wc, 3) uint8
    seg: torch.Tensor  # (N, Hc, Wc, 1) uint8
    hw: torch.Tensor  # (N, 2) int32
    center: torch.Tensor  # (N, 2) int32
    label: torch.Tensor  # (N, 3, 19)


class MocapBatch(NamedTuple):
    """Real samples for the critic."""

    joints: torch.Tensor  # (M, >=14, 3)
    shapes: torch.Tensor  # (M, 10)
    rotations: torch.Tensor  # (M, 23, 3, 3)


@torch.no_grad()
def mocap_batch(smpl, pose: torch.Tensor, shape: torch.Tensor) -> MocapBatch:
    """Real critic samples from mocap ``pose`` (M, 3J) axis-angle (J the body
    model's joints: 72 numbers for SMPL) and ``shape`` (M, 10) on the body
    model's device: one batched body-model forward with the 19 cocoplus
    joints (a neutral expression where the model has one), the rotations
    without the root; on the card a replay of the forward graph of
    ``body_graph.MOCAP``'s slot."""
    out = body_graph.forward(body_graph.MOCAP, smpl, shape, pose, joint_type="cocoplus")
    return MocapBatch(joints=out.joints, shapes=shape, rotations=out.rotations[:, 1:])


@dataclasses.dataclass
class StepMetrics:
    kpr_losses: torch.Tensor  # (num_stage,)
    mr_losses: torch.Tensor  # (num_stage,)
    gen_critic_losses: torch.Tensor  # (num_stage,)
    generator_loss: torch.Tensor
    critic_loss: torch.Tensor
    critic_penalty: torch.Tensor
    bone_length_pred: torch.Tensor
    bone_length_gt: torch.Tensor
    detection_loss: torch.Tensor  # the detection loss; 0 without person slots


@contextlib.contextmanager
def _mode(training: bool, *modules):
    """Put the modules in train or eval mode for the block, then restore
    the mode each had."""
    before = [m.training for m in modules]
    for m in modules:
        m.train(training)
    try:
        yield
    finally:
        for m, was in zip(modules, before):
            m.train(was)


def _valid_rows(batch) -> Optional[torch.Tensor]:
    """The (B*K,) weights of a ``SlotBatch``'s rows, 1 for a valid slot and
    0 for a padded one; None for a batch of one person an image."""
    valid = getattr(batch, "valid", None)
    if valid is None:
        return None
    if pmesh.is_distributed():
        raise NotImplementedError("the person-slot layout's means are one process's")
    return valid.reshape(-1)


def _stage_losses(stages, batch: GenBatch, critic, c_matrix, cfg: Config, project):
    """Per-stage (kpr, mr, critic) losses, each stacked to (num_stage,).
    ``project`` is the model's camera (``HMR.project``)."""
    kpr, mr, gcl = [], [], []
    zero = torch.zeros((), device=batch.kp2d.device)
    rows = _valid_rows(batch)
    for i, s in enumerate(stages):
        # labels carry 19 cocoplus points; a 14-joint LSP head compares the
        # first 14 (the face points have zero visibility on LSP data)
        kp_gt = batch.kp2d[:, : s.kp2d.shape[1]]
        kpr.append(cfg.kpr_loss_weight * L.keypoint_reprojection_loss(kp_gt, s.kp2d))
        # mr_metric_stages='last' skips the early stages' chamfer entirely
        mr_wanted = cfg.mr_metric_stages == "all" or i == len(stages) - 1
        if cfg.use_mesh_repro_loss and mr_wanted:
            sil_pred = (project(s.verts, s.cam) + 1.0) * 0.5 * float(cfg.img_size)
            loss = L.mesh_reprojection_loss(batch.seg_points, batch.seg_mask, sil_pred, scale_mode=cfg.mr_scale_mode)
            if rows is not None:  # a padded slot's mask is empty: its term is 0
                loss = loss / rows.sum().clamp_min(1.0)
            mr.append(cfg.mr_loss_weight * loss)
        else:
            mr.append(zero)
        if not cfg.encoder_only:
            with span("critic.score"):
                scores = critic(K.kcs(s.joints3d, c_matrix), s.joints3d[:, :14], s.shape, s.rotations)
            mean = pmesh.mean_share(scores, 0) if rows is None else L.masked_mean(scores, rows)
            gcl.append(cfg.critic_loss_weight * -mean.sum())
        else:
            gcl.append(zero)
    return torch.stack(kpr), torch.stack(mr), torch.stack(gcl)


def make_val_step(hmr, critic, cfg: Config, return_stages: bool = False):
    """Build ``val_step(mean_theta, batch) -> dict`` for the HMR and critic
    modules (which hold their parameters) — evaluation forward + losses,
    no updates. The step runs both modules in eval mode and gives them back
    in the mode they had.

    return_stages=True also returns the per-stage keypoints / verts / cams
    stacked on a leading stage axis (for per-stage visualization).

    Under a process group the losses are the global batch's on every rank
    (every rank must call the step); the predictions are this rank's rows.
    """
    c_matrix = torch.as_tensor(K.bone_incidence_matrix(), device=hmr.device)

    @torch.no_grad()
    def val_step(mean_theta: torch.Tensor, batch: GenBatch, encoder_qparams=None):
        # eval mode whatever a training step left: running BN statistics,
        # no dropout (the JAX step passes train=False)
        with _mode(False, hmr, critic):
            stages = hmr(batch.images, mean_theta, smpl_stages="all", encoder_qparams=encoder_qparams,
                         slots=getattr(batch, "slots", None))
            kpr, mr, gcl = pmesh.global_sums(_stage_losses(stages, batch, critic, c_matrix, cfg, hmr.project))
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


def _gp_uniforms(fake_joints, fake_shapes, fake_rs, generator: Optional[torch.Generator]):
    """The gradient penalty's interpolation coefficients: one uniform per
    ELEMENT of each input (the reference's quirk; the paper draws one per
    sample), drawn from the step's generator. The arguments have the
    GLOBAL batch's shapes (the step keeps this rank's rows)."""

    def draw(t):
        return torch.rand(t.shape, generator=generator, device=t.device, dtype=t.dtype)

    return draw(fake_joints), draw(fake_shapes), draw(fake_rs)


def _apply(opt, sched, params, grads) -> None:
    """One optimizer update from explicit gradients, then the schedule."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    sched.step()
    for p in params:
        p.grad = None


def make_train_step(cfg: Config, device=None):
    """Build ``train_step(state, batch, mocap, generator) -> StepMetrics``.

    The step updates ``state`` in place (parameters, BN statistics,
    optimizer states, ``state.step``): first the generator, then — unless
    ``cfg.encoder_only`` or ``mocap is None`` — the critic. ``generator``
    is a ``torch.Generator`` on the state's device; it draws the dropout
    masks and the penalty's uniforms. The step leaves the modules in the
    mode it found them. Runs on ``cuda`` unless ``device`` says otherwise.
    """
    body = _step_body(cfg, resolve_device(device))

    def train_step(
        state: TrainState, batch: GenBatch, mocap: Optional[MocapBatch], generator: Optional[torch.Generator]
    ) -> StepMetrics:
        with span("step"):
            return body(state, batch, mocap, generator)

    return train_step


def _step_body(cfg: Config, dev: torch.device):
    """``make_train_step``'s step without its ``step`` span, which the fused
    step holds around its input preparation too."""
    c_matrix = torch.as_tensor(K.bone_incidence_matrix(), device=dev)

    def generator_loss(state: TrainState, batch: GenBatch, generator):
        with span("gen.forward"), _mode(True, state.hmr):
            stages = state.hmr(batch.images, state.mean_theta, smpl_stages="all", generator=generator,
                               slots=getattr(batch, "slots", None))
        with span("gen.losses"):
            kpr, mr, gcl = _stage_losses(stages, batch, state.critic, c_matrix, cfg, state.hmr.project)
            loss = torch.zeros((), device=dev)
            if cfg.use_kpr_loss:
                loss = loss + kpr[-1]
            if cfg.use_mesh_repro_loss:
                loss = loss + mr[-1]
            if not cfg.encoder_only:
                loss = loss + gcl[-1]
            if cfg.cam_scale_hinge > 0.0:
                # gauge fix: keep the last stage's weak-perspective scale out of
                # the mirrored s < 0 gauge; zero whenever s >= margin
                s = stages[-1].cam[:, 0]
                loss = loss + cfg.cam_scale_hinge * pmesh.mean_share(torch.relu(cfg.cam_scale_margin - s).square())
        detection = torch.zeros((), device=dev)
        last = stages[-1]
        if last.detection is not None:
            with span("gen.detect"):
                # 1 at each patch that holds a valid slot's centre
                target = torch.zeros_like(last.detection).scatter_reduce_(
                    1, last.patches, batch.valid.to(last.detection.dtype), "amax")
                detection = F.binary_cross_entropy_with_logits(last.detection, target)
            loss = loss + detection
        return loss, stages, (kpr, mr, gcl, detection)

    def critic_loss(critic, fakes, real: MocapBatch, generator, rows) -> Tuple[torch.Tensor, torch.Tensor]:
        """The WGAN-GP loss on the fakes against ``real``; ``rows`` weighs
        the fakes' rows (the valid slots'), None for every row."""
        fake_joints, fake_shapes, fake_rs = fakes
        real_joints = real.joints[:, :14]
        real_out = critic(K.kcs(real_joints, c_matrix), real_joints, real.shapes, real.rotations)
        fake_out = critic(K.kcs(fake_joints, c_matrix), fake_joints, fake_shapes, fake_rs)
        # WGAN loss: the sum over the 3 heads of the batch-mean margin
        margin = fake_out - real_out
        wgan = (pmesh.mean_share(margin, 0) if rows is None else L.masked_mean(margin, rows)).sum()
        penalty = torch.zeros((), device=dev)
        if cfg.use_gradient_penalty:
            # drawn for the global batch's fakes (empty stand-ins of its
            # shapes under a process group), this rank's rows kept
            shaped = [
                t.new_empty((t.shape[0] * pmesh.world_size(), *t.shape[1:])) if pmesh.is_distributed() else t
                for t in fakes
            ]
            alpha, beta, gamma = (
                pmesh.local_rows(u, blocks=cfg.num_stage) for u in _gp_uniforms(*shaped, generator)
            )
            i_joints = (fake_joints + alpha * (real_joints - fake_joints)).detach()
            i_shapes = (fake_shapes + beta * (real.shapes - fake_shapes)).detach()
            i_rs = (fake_rs + gamma * (real.rotations - fake_rs)).detach()
            # the KCS is an input of its own, as in the JAX step: built from
            # the detached joints before any input requires a gradient, so
            # the joints' gradient does not take the path through kcs
            i_kcs = K.kcs(i_joints, c_matrix)
            inputs = [t.requires_grad_() for t in (i_kcs, i_joints, i_shapes, i_rs)]
            with span("critic.penalty"):
                out = critic(i_kcs, i_joints[:, :14], i_shapes, i_rs)
                grads = torch.autograd.grad(out.sum(), inputs, create_graph=True)
                penalty = L.gradient_penalty(grads, mode=cfg.gp_mode, rows=rows)
            wgan = wgan + 10.0 * penalty
        return wgan, penalty

    def step(
        state: TrainState, batch: GenBatch, mocap: Optional[MocapBatch], generator: Optional[torch.Generator]
    ) -> StepMetrics:
        # ------------------------- generator update -----------------------
        gen_loss, stages, (kpr, mr, gcl, detection) = generator_loss(state, batch, generator)
        rows = _valid_rows(batch)
        rows = None if rows is None else rows.repeat(len(stages))  # the fakes: every stage's rows
        gen_params = state.gen_params()
        with span("gen.backward"):
            grads = torch.autograd.grad(gen_loss, gen_params, allow_unused=True)
            grads = pmesh.all_reduce_grads(gen_params, grads)  # one flat all-reduce; identity on one process
        with span("gen.adam"):
            _apply(state.gen_opt, state.gen_sched, gen_params, grads)

        fake_joints = torch.cat([s.joints3d[:, :14] for s in stages]).detach()
        fake_shapes = torch.cat([s.shape for s in stages]).detach()
        fake_rs = torch.cat([s.rotations for s in stages]).detach()
        zero = torch.zeros((), device=dev)

        # --------------------------- critic update ------------------------
        if cfg.encoder_only or mocap is None:
            c_loss, penalty = zero, zero
        else:
            with span("critic.forward"):
                c_loss, penalty = critic_loss(state.critic, (fake_joints, fake_shapes, fake_rs), mocap, generator, rows)
            c_params = list(state.critic.parameters())
            with span("critic.backward"):
                c_grads = pmesh.all_reduce_grads(c_params, torch.autograd.grad(c_loss, c_params, allow_unused=True))
            with span("critic.adam"):
                _apply(state.critic_opt, state.critic_sched, c_params, c_grads)

        state.step += 1
        with span("step.metrics"), torch.no_grad():
            bones = K.bone_lengths_sq(fake_joints, c_matrix).sum(dim=1)
            bone_pred = pmesh.mean_share(bones) if rows is None else L.masked_mean(bones, rows)
            # a metric, not a critic input: computed whenever mocap is given
            bone_gt = (
                pmesh.mean_share(K.bone_lengths_sq(mocap.joints[:, :14], c_matrix).sum(dim=1))
                if mocap is not None
                else zero
            )
            # the ranks' shares summed into the global batch's values
            fields = pmesh.global_sums((kpr, mr, gcl, gen_loss, c_loss, penalty, bone_pred, bone_gt, detection))
        return StepMetrics(*(t.detach() for t in fields))

    return step


def make_fused_train_step(cfg: Config, smpl, augment: bool = True, device=None):
    """Build ``fused(state, host, mocap_raw, generator) -> StepMetrics``:
    the training step from raw host data, counterpart of the JAX
    ``make_fused_train_step``.

    ``host`` is a ``HostBatch``: it is copied to the device (through pinned
    memory, without blocking the host), augmented with draws from
    ``generator`` and turned into silhouettes (``data.pipeline.
    DevicePreprocessor``); a ``CrowdHostBatch``, for a model whose head
    takes person slots, is made a ``SlotBatch`` by ``data.pipeline.
    SlotPreprocessor``; ``mocap_raw=(pose (M, 3J), shape (M, 10))``, or
    None, is posed by one batched body-model forward into a ``MocapBatch``;
    then ``make_train_step``'s step runs on the same generator. The
    augmentation draws first, so the step equals ``DevicePreprocessor``
    followed by ``make_train_step`` on one generator. Runs on ``cuda`` unless
    ``device`` says otherwise."""
    # data.pipeline imports this module (GenBatch)
    from ..data.pipeline import DevicePreprocessor, SlotPreprocessor, to_device

    dev = resolve_device(device)
    # the augmentation draws for the global batch under a process group
    crop_prep, slot_prep = (p(cfg, augment=augment, device=dev, global_draws=True)
                            for p in (DevicePreprocessor, SlotPreprocessor))
    body = smpl.to(dev)
    base = _step_body(cfg, dev)

    def fused(
        state: TrainState, host: Union[HostBatch, CrowdHostBatch], mocap_raw: Optional[Tuple], generator: Optional[torch.Generator]
    ) -> StepMetrics:
        with span("step"):
            prep = slot_prep if isinstance(host, CrowdHostBatch) else crop_prep
            batch = prep(host._asdict(), generator)
            mocap = None
            if mocap_raw is not None:
                with span("step.mocap"):
                    pose, shape = (to_device(t, dev) for t in mocap_raw)
                    mocap = mocap_batch(body, pose, shape)
            return base(state, batch, mocap, generator)

    return fused


def make_multi_step(step_fn, k: int):
    """Build ``multi(state, batches, mocaps, generator) -> StepMetrics``: k
    calls of ``step_fn`` (a train or fused step) in order on one state and
    one generator, ``batches`` and ``mocaps`` (or None) k of each, with the
    k ``StepMetrics`` stacked field by field on the device (each field gains
    a leading axis of k), so that one transfer reads them all. It is the k
    calls: the generator advances through them as it would through k
    separate calls."""

    def multi(state: TrainState, batches, mocaps, generator: Optional[torch.Generator]) -> StepMetrics:
        mocaps = (None,) * k if mocaps is None else tuple(mocaps)
        if len(batches) != k or len(mocaps) != k:
            raise ValueError(f"make_multi_step({k}) takes {k} batches and {k} mocaps (or None)")
        steps = [step_fn(state, b, m, generator) for b, m in zip(batches, mocaps)]
        return StepMetrics(**{
            f.name: torch.stack([getattr(s, f.name) for s in steps]) for f in dataclasses.fields(StepMetrics)
        })

    return multi
