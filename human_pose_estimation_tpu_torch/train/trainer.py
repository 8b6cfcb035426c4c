"""Training orchestration: epochs, logging, validation, checkpoints
(counterpart of ``human_pose_estimation_tpu/train/trainer.py``), on one
device per process.

Around the step functions of ``train/step.py``:

* epoch accounting from the dataset-size table (``data/tfrecords.py``)
  with a progress bar and an ETA;
* scalars through separate train / val ``SummaryWriter``s every
  ``scalar_log_step`` steps and on the last step of each epoch, read in
  ONE device-to-host copy per dispatch, and none on the steps that do not
  log; rendered mesh / skeleton / silhouette panels every ``log_img_step``;
* validation every ``validation_step_size`` steps;
* a checkpoint every ``checkpoint_every_epochs`` epochs: the whole state
  and the input streams' positions (``utils/checkpoint.py``);
* ``profile_dir``: a ``torch.profiler`` Chrome trace from
  ``profile_start_step`` to ``profile_end_step``;
* the full checkpoint validation sweep: mean KPR / MR losses, PCK@0.5,
  the PCK curve, its AUC and per-joint PCK, and best / worst rendering.

Every dispatch draws from a generator seeded from (``seed + 1``, the
state's step) alone (``train.state.step_generator``), as the JAX loop folds
its key on ``state.step``: a run resumed from a checkpoint draws what the
straight run drew.

Data parallelism (the JAX trainer's mesh): under a process group
(``parallel/mesh.py``, launched with torchrun) every rank runs this loop
on its own rows and the steps reduce over the ranks (``train/step.py``).
``config.batch_size`` is the per-process batch and the global batch is R
times it. A JAX host is a torchrun node and a JAX device is a card, so
the JAX per-host batch is ``batch_size`` x ``LOCAL_WORLD_SIZE``, and an
epoch counts ``num_images / (batch_size x local world)`` steps, as the
JAX trainer divides by its per-host batch: one pass over the data on one
node, N passes on N nodes (each JAX host reads 1/N of it). The state
starts replicated from rank 0 and stays equal on every rank; rank 0 alone
writes summaries, images and checkpoints (behind a barrier), every rank
restores, and ``validate_checkpoint`` reports the global batches' means.
The mocap stream is not sharded: every rank draws the same samples, as
every JAX host shuffles it with ``cfg.seed``.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..core.smpl import load_model
from ..data import tfrecords
from ..ops.metrics import pck, pck_auc, pck_curve, per_joint_pck
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt
from ..utils.mean_params import load_mean_theta
from ..utils.summary import SummaryWriter
from .state import TrainState, create_train_state, step_generator
from .step import StepMetrics, make_fused_train_step, make_multi_step, make_train_step, make_val_step

_METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(StepMetrics))


def fetch_metrics(metrics: StepMetrics) -> Dict[str, np.ndarray]:
    """Every field of ``metrics`` on the host in one device-to-host copy:
    the fields are flattened into one tensor on the device, copied, and
    split again."""
    parts = [getattr(metrics, f).detach().reshape(-1) for f in _METRIC_FIELDS]
    dtype = functools.reduce(torch.promote_types, (p.dtype for p in parts))
    flat = torch.cat([p.to(dtype) for p in parts]).cpu().numpy()
    out, at = {}, 0
    for f, p in zip(_METRIC_FIELDS, parts):
        out[f] = flat[at : at + p.numel()].reshape(getattr(metrics, f).shape)
        at += p.numel()
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Trainer:
    def __init__(
        self,
        config: Config,
        dataset=None,  # iterator of (GenBatch, n), or (HostBatch, n) with fuse_preprocess
        mocap_dataset=None,  # iterator of MocapBatch, or raw (pose, shape) with fuse_preprocess
        val_dataset=None,
        validation_only: bool = False,
        smpl=None,
        device=None,
    ):
        """``device``: ``cuda`` unless the caller asks for the CPU."""
        self.device = resolve_device(device)
        self.chief = pmesh.rank() == 0  # the rank that writes summaries, images and checkpoints
        self.config = config
        self.dataset = dataset
        self.mocap_dataset = mocap_dataset
        self.val_dataset = val_dataset
        self.validation_only = validation_only

        self.smpl = smpl if smpl is not None else load_model(config.smpl_model_path)
        mean_theta = load_mean_theta(config.mean_params_path)
        self.state: TrainState = create_train_state(
            self.smpl, mean_theta, config, device=self.device, seed=config.seed
        )
        if config.init_encoder_from and not config.train_from_checkpoint:
            self._graft_encoder(config.init_encoder_from)

        if config.fuse_preprocess:
            # augmentation and the mocap body model inside the step: the
            # pipelines hand over HostBatches and raw (pose, shape)
            step_fn = make_fused_train_step(config, self.smpl, augment=True, device=self.device)
        else:
            step_fn = make_train_step(config, device=self.device)
        self.train_step = step_fn
        self._multi_step = (
            make_multi_step(step_fn, config.steps_per_call) if config.steps_per_call > 1 else None
        )
        self.val_step = make_val_step(self.state.hmr, self.state.critic, config)
        self._viz_step = None  # lazy: per-stage val step for image panels

        if config.num_examples_override > 0:
            num_images = config.num_examples_override
        else:
            try:
                num_images = tfrecords.num_examples(config.datasets)
            except KeyError as e:
                raise ValueError(
                    f"unknown dataset size for {e.args[0]!r}: epoch accounting needs the "
                    "example count. Add it to data/tfrecords.NUM_EXAMPLES or set "
                    "--num_examples_override."
                ) from e
        # the JAX trainer divides by its per-host batch; a host is a node here
        self.num_itr_per_epoch = max(num_images / (config.batch_size * pmesh.local_world_size()), 1)

        self.writers: Dict[str, SummaryWriter] = {}
        if not validation_only and config.model_dir and self.chief:
            self.writers["train"] = SummaryWriter(os.path.join(config.model_dir, "training"))
            self.writers["val"] = SummaryWriter(os.path.join(config.model_dir, "validation"))
        self._renderer = None
        self._profiler = None

    # ------------------------------------------------------------------
    def _writer(self, name: str) -> SummaryWriter:
        if name not in self.writers:
            self.writers[name] = SummaryWriter(None)
        return self.writers[name]

    @property
    def renderer(self):
        if self._renderer is None:
            from ..viz.renderer import SMPLRenderer

            faces = self.smpl.faces
            if faces is None:
                faces = np.zeros((0, 3), np.int64)
            self._renderer = SMPLRenderer(img_size=self.config.img_size, faces=faces)
        return self._renderer

    def _graft_encoder(self, donor_dir: str) -> None:
        """Pretrained-encoder init (``Config.init_encoder_from``): copy the
        encoder's weights and BN statistics out of another run's checkpoint
        (either layout) into this fresh state. Everything else (regressor,
        critic, mean theta, both optimizers, step 0) starts anew."""
        raw, step = ckpt.restore_raw(donor_dir)  # on the host: copy_ moves only the encoder
        try:
            donor = {k: v for k, v in raw["hmr"].items() if k.startswith("encoder.")}
        except (KeyError, TypeError, AttributeError) as e:
            raise ValueError(
                f"checkpoint under {donor_dir!r} has no encoder subtree (is it a TrainState checkpoint?)"
            ) from e
        own = {k: v for k, v in self.state.hmr.state_dict().items() if k.startswith("encoder.")}
        if set(donor) != set(own) or any(tuple(donor[k].shape) != tuple(v.shape) for k, v in own.items()):
            raise ValueError(
                f"encoder in {donor_dir!r} (step {step}) does not match this model's encoder "
                "structure — same encoder_depth/stage sizes required for init_encoder_from"
            )
        with torch.no_grad():
            for k, v in own.items():  # state_dict tensors share the modules' storage
                v.copy_(donor[k])
        self._print(f"initialized encoder from {donor_dir} (step {step})")

    # ------------------------------------------------------------------
    def restore(self) -> Optional[int]:
        """Load the latest checkpoint of ``checkpoint_dir`` (either layout)
        into the state, and the input streams' positions into the
        pipelines that take them (``set_state``); the step, or None."""
        self.state, step = ckpt.restore_train_state(self.config.checkpoint_dir, self.state)
        if step is not None:
            input_state = ckpt.restore_input_state(self.config.checkpoint_dir, step)
            if input_state is not None:
                # current format: {"image": ..., "mocap": ...}; legacy
                # checkpoints stored the image pipeline's state bare
                legacy = "image" not in input_state and "mocap" not in input_state
                img_state = input_state if legacy else input_state.get("image")
                mocap_state = None if legacy else input_state.get("mocap")
                if img_state is not None and hasattr(self.dataset, "set_state"):
                    self.dataset.set_state(img_state)
                if mocap_state is not None and hasattr(self.mocap_dataset, "set_state"):
                    self.mocap_dataset.set_state(mocap_state)
        return step

    def save(self) -> None:
        img_state = self.dataset.get_state() if hasattr(self.dataset, "get_state") else None
        mocap_state = self.mocap_dataset.get_state() if hasattr(self.mocap_dataset, "get_state") else None
        input_state = None
        if img_state is not None or mocap_state is not None:
            input_state = {"image": img_state, "mocap": mocap_state}
        ckpt.save_train_state(self.config.checkpoint_dir, self.state, input_state=input_state)

    # ------------------------------------------------------------------
    def _profile(self, step: int) -> None:
        """Open the profiler after ``profile_start_step`` and write its
        Chrome trace at ``profile_end_step``."""
        cfg = self.config
        if not cfg.profile_dir or not self.chief:
            return
        if step == cfg.profile_start_step and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif step == cfg.profile_end_step and self._profiler is not None:
            self._stop_profiler(step)

    def _stop_profiler(self, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(
            self.config.profile_dir, f"steps_{self.config.profile_start_step}_{step}.pt.trace.json"
        )
        self._profiler.export_chrome_trace(path)
        self._profiler = None

    def train(self, max_steps: Optional[int] = None) -> Dict[str, List[float]]:
        """Run the training loop. ``max_steps`` bounds the total step count
        (tests / smoke runs); otherwise it runs ``config.epoch`` epochs by
        the reference's fractional epoch accounting."""
        cfg = self.config
        start_step = 0
        if cfg.train_from_checkpoint:
            restored = self.restore()
            self._print(f"restored checkpoint at step {restored}")
            start_step = restored or 0

        history = {"kpr": [], "mr": [], "gen_critic": [], "critic": []}
        epoch_acc = {k: [] for k in history}
        train_writer = self._writer("train")
        val_writer = self._writer("val")
        val_iter = iter(self.val_dataset) if self.val_dataset is not None else None
        mocap_iter = iter(self.mocap_dataset) if self.mocap_dataset is not None else None
        need_mocap = not cfg.encoder_only or cfg.do_bone_evaluation

        k = max(cfg.steps_per_call, 1)
        data_iter = iter(self.dataset)
        itr, epoch, global_itr = 0, 0, 0
        t_epoch = time.time()
        t_step = time.time()
        last_logged_step = start_step
        stop = False
        while not stop:
            # -- this dispatch's batches ---------------------------------
            try:
                gathered = []
                for _ in range(k):
                    b, _n = next(data_iter)
                    m = next(mocap_iter) if (mocap_iter is not None and need_mocap) else None
                    gathered.append((b, m))
            except StopIteration:
                break
            gen = step_generator(cfg.seed + 1, self.state.step, self.device)
            if k == 1:
                metrics = self.train_step(self.state, gathered[0][0], gathered[0][1], gen)
            else:
                # k steps in one call, metrics stacked (k, ...) on the device
                mocaps = [g[1] for g in gathered] if gathered[0][1] is not None else None
                metrics = self._multi_step(self.state, [g[0] for g in gathered], mocaps, gen)
            got = None  # the metrics on the host, copied once per dispatch when a step logs

            for j in range(k):
                # host-side step counter: reading the state would not sync,
                # but this is the loop's own count
                global_itr += 1
                step = start_step + global_itr
                self._profile(step)

                # The last step of each epoch always logs, so that the epoch
                # averages and `history` are never empty when the cadence
                # exceeds the epoch length.
                cadence = max(cfg.scalar_log_step, 1)
                epoch_final = itr + 1 >= self.num_itr_per_epoch
                do_scalars = cadence == 1 or step % cadence == 0 or epoch_final
                if do_scalars:
                    if got is None:
                        got = fetch_metrics(metrics)
                    row = {f: v[j] for f, v in got.items()} if k > 1 else got
                    now = time.time()
                    train_writer.scalar(
                        "perf/step_time_ms", (now - t_step) * 1e3 / max(step - last_logged_step, 1), step
                    )
                    t_step = now
                    last_logged_step = step

                    # -- scalars ------------------------------------------
                    if cfg.use_kpr_loss:
                        v = float(row["kpr_losses"][-1])
                        train_writer.scalar("generator/kpr_loss", v, step)
                        history["kpr"].append(v)
                        epoch_acc["kpr"].append(v)
                    if cfg.use_mesh_repro_loss:
                        v = float(row["mr_losses"][-1])
                        train_writer.scalar("generator/mr_loss", v, step)
                        history["mr"].append(v)
                        epoch_acc["mr"].append(v)
                    if cfg.do_bone_evaluation:
                        train_writer.scalar("bones/avg_total_bone_length_pred", float(row["bone_length_pred"]), step)
                        train_writer.scalar("bones/avg_total_bone_length_gt", float(row["bone_length_gt"]), step)
                    if not cfg.encoder_only:
                        c_loss = float(row["critic_loss"])
                        gc_loss = float(row["gen_critic_losses"][-1])
                        train_writer.scalar("critic/critic_network_loss", c_loss, step)
                        train_writer.scalar("critic/generator_critic_loss", gc_loss, step)
                        train_writer.scalar("critic/penalty", float(row["critic_penalty"]), step)
                        history["critic"].append(c_loss)
                        epoch_acc["critic"].append(c_loss)
                        history["gen_critic"].append(gc_loss)
                        epoch_acc["gen_critic"].append(gc_loss)

                # -- image summaries --------------------------------------
                if cfg.log_img_step and step % cfg.log_img_step == 0:
                    self._log_images(train_writer, gathered[j][0], step)

                # -- validation every N steps -----------------------------
                if cfg.use_validation and val_iter is not None and step % cfg.validation_step_size == 0:
                    try:
                        val_batch, _ = next(val_iter)
                    except StopIteration:
                        val_iter = iter(self.val_dataset)
                        val_batch, _ = next(val_iter)
                    vout = self.val_step(self.state.mean_theta, val_batch)
                    kpr_v, mr_v = torch.stack([vout["kpr_losses"][-1], vout["mr_losses"][-1]]).tolist()
                    if cfg.use_kpr_loss:
                        val_writer.scalar("generator/kpr_loss", kpr_v, step)
                    if cfg.use_mesh_repro_loss:
                        val_writer.scalar("generator/mr_loss", mr_v, step)
                    if cfg.log_img_step and step % cfg.log_img_step == 0:
                        self._log_images(val_writer, val_batch, step)

                itr += 1
                self._progress(epoch, itr)

                # -- epoch boundary ---------------------------------------
                if itr >= self.num_itr_per_epoch:
                    itr = 0
                    epoch += 1
                    dt = time.time() - t_epoch
                    if epoch % cfg.checkpoint_every_epochs == 0:
                        self.save()
                    msg = f"Finished epoch {epoch - 1}, average losses:"
                    for key, label in (("kpr", "kpr"), ("mr", "mr"), ("gen_critic", "gc"), ("critic", "cn")):
                        if epoch_acc[key]:
                            msg += f" {label}={np.mean(epoch_acc[key]):.2f}"
                    self._print(msg)
                    epoch_acc = {key: [] for key in epoch_acc}
                    if epoch >= cfg.epoch:
                        stop = True
                        break
                    eta = datetime.datetime.now() + datetime.timedelta(seconds=(cfg.epoch - epoch) * dt)
                    self._print(f"Starting epoch {epoch} ({dt / 60:.2f} min/epoch, approx done {eta})")
                    t_epoch = time.time()

                if max_steps is not None and step >= max_steps:
                    stop = True
                    break

        if self._profiler is not None:  # the run ended inside the window
            self._stop_profiler(start_step + global_itr)
        for w in self.writers.values():
            w.flush()
        return history

    def _print(self, *args, **kw) -> None:
        if self.chief:
            print(*args, **kw)

    def _progress(self, epoch: int, itr: int) -> None:
        if not self.chief:
            return
        length = 30
        stride = max(int(self.num_itr_per_epoch / length), 1)
        if itr % stride == 0 or itr == 1:
            frac = min(itr / self.num_itr_per_epoch, 1.0)
            filled = int(length * frac)
            bar = "#" * filled + "-" * (length - filled)
            print(f"\rEpoch {epoch}: |{bar}| {100 * frac:.1f}%", end="", flush=True)
        if itr >= self.num_itr_per_epoch:
            print()

    # ------------------------------------------------------------------
    @property
    def viz_step(self):
        """The per-stage val step (built lazily: only image logging needs
        the stacked per-stage vertices)."""
        if self._viz_step is None:
            self._viz_step = make_val_step(self.state.hmr, self.state.critic, self.config, return_stages=True)
        return self._viz_step

    def _log_images(self, writer, batch, step: int, vout=None) -> None:
        """The reference's visualization grid: one row per IEF stage, each
        row [skeleton gt + pred | mesh over the image | mesh over the gt
        silhouette], rows stacked per example. An exception is printed,
        never raised: visualization must not end a training run. Under a
        process group every rank runs the forward (its losses reduce over
        the ranks) and rank 0 renders its own rows."""
        try:
            from ..viz.renderer import draw_skeleton, draw_text

            if vout is None or "stage_verts" not in vout:
                vout = self.viz_step(self.state.mean_theta, batch)
            if not self.chief:
                return
            n_show = min(3, batch.images.shape[0])
            images = _np(batch.images)
            kp_gt = _np(batch.kp2d)
            seg_pts = _np(batch.seg_points)
            seg_mask = _np(batch.seg_mask)
            stage_kp = _np(vout["stage_kp2d"])  # (S, N, K, 2)
            stage_verts = _np(vout["stage_verts"])  # (S, N, V, 3)
            stage_cams = _np(vout["stage_cams"])  # (S, N, 3)
            size = self.config.img_size
            render_mesh = self.smpl.faces is not None and len(self.smpl.faces)
            for i in range(n_show):
                img01 = (images[i] + 1) * 0.5
                # dense gt silhouette image from the padded pixel list
                seg_img = np.zeros((size, size, 3), np.float32)
                valid = seg_mask[i] > 0
                if valid.any():
                    xs = np.clip(seg_pts[i, valid, 0].round().astype(int), 0, size - 1)
                    ys = np.clip(seg_pts[i, valid, 1].round().astype(int), 0, size - 1)
                    seg_img[ys, xs] = 1.0
                gt_px = (kp_gt[i, :, :2] + 1) * 0.5 * size
                vis = kp_gt[i, :, 2] > 0
                rows = []
                for s in range(stage_kp.shape[0]):
                    pr_px = (stage_kp[s, i] + 1) * 0.5 * size
                    panel = draw_skeleton(img01, gt_px, draw_edges=False, vis=vis)
                    panel = np.asarray(draw_skeleton(panel, pr_px), np.float32)
                    panels = [panel]
                    if render_mesh:
                        cam = stage_cams[s, i]
                        f = 5.0
                        tz = f / max(float(cam[0]), 1e-6)
                        cam_t = np.array([cam[1], cam[2], tz])
                        cam_render = 0.5 * size * np.array([f, 1, 1])
                        v_shift = stage_verts[s, i] + cam_t
                        rend = self.renderer(v_shift, cam_render, img=img01, ssaa=2) / 255.0
                        rend = draw_text(rend, {"sc": cam[0], "tx": cam[1], "ty": cam[2]})
                        panels.append(np.asarray(rend, np.float32))
                        rend_seg = self.renderer(v_shift, cam_render, img=seg_img, ssaa=2) / 255.0
                        panels.append(np.asarray(rend_seg, np.float32))
                    rows.append(np.hstack(panels))
                writer.image(f"vis_images/{i}", np.vstack(rows), step)
            writer.flush()
        except Exception as e:  # visualization must never kill training
            print(f"[viz] image logging failed: {e}")

    # ------------------------------------------------------------------
    def validate_checkpoint(
        self,
        draw_best_worst: bool = False,
        draw_every_image: bool = False,
        restore: bool = True,
    ) -> Dict[str, float]:
        """The full validation sweep: mean KPR / MR loss, PCK@0.5, the PCK
        curve at 0.1-0.5, its AUC and per-joint PCK, with optional best /
        worst batch renders. With ``config.encoder_int8`` the sweep runs
        the int8 serving encoder, quantized from the restored weights and
        calibrated on the first validation batch (under a process group,
        each rank's first batch, as each JAX host calibrates on its own).

        Under a process group each rank sweeps its own validation stream
        (the ranks must yield the same number of batches) and the results
        are those of the global batches: the losses are reduced in the step
        and the keypoints of every rank's valid rows are gathered for PCK."""
        if restore:
            self.restore()
        if self.val_dataset is None:
            raise ValueError("validate_checkpoint needs a val dataset")
        writer = self._writer("checkpoint_val")

        qparams = None
        if self.config.encoder_int8:
            # quantize the restored encoder once, calibrate on the first
            # validation batch, and sweep the int8 serving graph, so that
            # the task metrics report its accuracy
            first_batch, _ = next(iter(self.val_dataset))
            qparams = self.state.hmr.quantize_encoder(calibration_images=first_batch.images)

        kpr_losses, mr_losses, pcks = [], [], []
        gts, preds = [], []  # accumulated for the PCK curve, AUC and per-joint PCK
        best = {"val": np.inf, "batch": None, "out": None}
        worst = {"val": -np.inf, "batch": None, "out": None}
        step = 0
        for batch, n_valid in self.val_dataset:
            out = self.val_step(self.state.mean_theta, batch, qparams)
            k = out["pred_keypoints"].shape[1]
            kpr, mr = torch.stack([out["kpr_losses"][-1], out["mr_losses"][-1]]).tolist()
            # every rank's valid rows: the global batch (one process: this batch's)
            gt = pmesh.all_gather_rows(batch.kp2d[:n_valid, :k].detach()).cpu()
            pred = pmesh.all_gather_rows(out["pred_keypoints"][:n_valid].detach()).cpu()
            kpr_losses.append(kpr)
            mr_losses.append(mr)
            pcks.append(float(pck(gt, pred)))
            gts.append(gt)
            preds.append(pred)
            combined = kpr + mr
            if draw_best_worst:
                if combined < best["val"]:
                    best.update(val=combined, batch=batch, out=out)
                if combined > worst["val"]:
                    worst.update(val=combined, batch=batch, out=out)
            if draw_every_image:
                self._log_images(writer, batch, step, out)
            step += 1

        if draw_best_worst and best["batch"] is not None:
            self._log_images(writer, best["batch"], 0, best["out"])
            self._log_images(writer, worst["batch"], 1, worst["out"])

        results = {
            "mean_kpr_loss": float(np.mean(kpr_losses)) if kpr_losses else float("nan"),
            "mean_mr_loss": float(np.mean(mr_losses)) if mr_losses else float("nan"),
            "pck@0.5": float(np.mean(pcks)) if pcks else float("nan"),
        }
        thresholds = (0.1, 0.2, 0.3, 0.4, 0.5)
        if gts:
            gt_all, pred_all = torch.cat(gts), torch.cat(preds)
            curve = pck_curve(gt_all, pred_all, thresholds).tolist()
            results.update({f"pck@{t}": float(v) for t, v in zip(thresholds, curve)})
            results["pck_auc@0.5"] = float(pck_auc(gt_all, pred_all))
            results["per_joint_pck@0.5"] = [round(float(v), 4) for v in per_joint_pck(gt_all, pred_all).tolist()]
        self._print(f"average kpr_loss = {results['mean_kpr_loss']}")
        self._print(f"average mr_loss = {results['mean_mr_loss']}")
        self._print(f"PCK@0.5 = {results['pck@0.5']}")
        if gts:
            self._print(
                "PCK curve "
                + " ".join(f"@{t}={results[f'pck@{t}']:.3f}" for t in thresholds)
                + f" | AUC@0.5={results['pck_auc@0.5']:.3f}"
            )
        return results
