"""Typed configuration: the port's own copy of the JAX package's
``Config`` dataclass, ``parse_config`` and run-directory helpers
(``run_name``, ``prepare_dirs``, ``save_config``, ``load_config``; see
``human_pose_estimation_tpu/config.py``), field for field, so that one set
of settings drives both packages and a ``params.json`` written by either
loads in the other.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from datetime import datetime
from typing import List, Optional, Sequence


@dataclasses.dataclass
class Config:
    """The JAX package's ``Config``, field for field (see
    ``human_pose_estimation_tpu/config.py`` for what each field does there).
    This package reads: img_size, num_stage, joint_type, batch_size, the
    loss weights and toggles, the learning rates and schedule,
    encoder_dtype ('float32' | 'bfloat16', autocast on the card),
    encoder_depth, encoder_stage_sizes (a shallow encoder, e.g. "1,1,1,1"),
    encoder_int8 (the post-training int8 encoder for serving and the
    validation sweep, ``models/quantize.py``), remat_encoder, mr_scale_mode,
    mr_metric_stages, cam_scale_hinge / margin, gp_mode,
    max_silhouette_points, the augmentation (trans_max, scale_min,
    scale_max), seed, input_pipeline ('grain' is not ported), data_dir,
    datasets, val_datasets, mocap_datasets, smpl_model_path, and the
    loop's fields (``train/trainer.py``): epoch, the logging and
    validation cadences, checkpoint_dir / checkpoint_every_epochs /
    train_from_checkpoint / init_encoder_from, fuse_preprocess and
    steps_per_call (which step the trainer builds), num_examples_override,
    logs / model_dir and the profiler window (profile_dir,
    profile_start_step, profile_end_step: a ``torch.profiler`` trace).
    mesh_axis (data parallelism) is not ported."""

    # --- assets
    smpl_model_path: str = "models/model.pkl"
    smpl_mean_params_path: str = ""  # default: neutral_smpl_mean_params.h5 next to model
    smpl_face_path: str = ""  # optional; faces usually come from the model asset

    # --- general
    img_size: int = 224
    data_format: str = "NHWC"
    num_stage: int = 3
    joint_type: str = "lsp"

    # --- paths / datasets
    data_dir: str = "datasets"
    logs: str = "logs"
    model_dir: Optional[str] = None
    datasets: List[str] = dataclasses.field(
        default_factory=lambda: ["lsp_train", "lsp_ext"]
    )
    val_datasets: List[str] = dataclasses.field(default_factory=lambda: ["lsp_val"])
    mocap_datasets: List[str] = dataclasses.field(
        default_factory=lambda: ["CMU", "jointLim"]
    )

    # --- training
    validation_step_size: int = 50
    log_img_step: int = 1000
    scalar_log_step: int = 1
    steps_per_call: int = 1
    epoch: int = 125
    batch_size: int = 8
    generator_lr: float = 1e-4
    critic_lr: float = 5e-4
    lr_schedule: str = "constant"  # 'constant' | 'cosine'
    lr_decay_steps: int = 0
    kpr_loss_weight: float = 60.0
    mr_loss_weight: float = 1e-3
    critic_loss_weight: float = 1e-2

    # --- augmentation
    trans_max: int = 20
    scale_max: float = 1.23
    scale_min: float = 0.8

    # --- model / loss toggles
    use_mesh_repro_loss: bool = False
    use_kpr_loss: bool = True
    encoder_only: bool = False
    use_gradient_penalty: bool = True
    do_bone_evaluation: bool = True
    use_validation: bool = True

    # --- checkpointing
    train_from_checkpoint: bool = False
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_epochs: int = 5
    init_encoder_from: str = ""

    # --- debug
    debug: bool = False

    # --- implementation knobs (no reference equivalent)
    encoder_dtype: str = "bfloat16"
    encoder_depth: int = 50
    encoder_int8: bool = False
    max_silhouette_points: int = 16384
    cam_scale_hinge: float = 10.0
    cam_scale_margin: float = 0.1
    gp_mode: str = "reference"
    mr_scale_mode: str = "reference"
    mr_metric_stages: str = "all"  # 'all' | 'last'
    num_examples_override: int = 0
    encoder_stage_sizes: str = ""
    seed: int = 0
    input_pipeline: str = "tfrecord"
    mesh_axis: str = "data"
    remat_encoder: bool = False
    fuse_preprocess: bool = False  # augmentation + mocap SMPL inside the train step
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_end_step: int = 15

    def __post_init__(self):
        if self.data_format != "NHWC":
            # images enter NHWC at the public functions, as in the JAX
            # package; the encoder permutes them inside
            raise ValueError("data_format must be 'NHWC'")
        if self.joint_type not in ("cocoplus", "lsp"):
            raise ValueError("joint_type must be 'cocoplus' or 'lsp'")
        if self.input_pipeline not in ("tfrecord", "npz", "native", "grain"):
            raise ValueError(
                "input_pipeline must be 'tfrecord', 'npz', 'native', or 'grain'"
            )
        if self.encoder_depth not in (50, 101, 152):
            raise ValueError("encoder_depth must be 50, 101, or 152")
        if self.mr_metric_stages not in ("all", "last"):
            raise ValueError("mr_metric_stages must be 'all' or 'last'")
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError("lr_schedule must be 'constant' or 'cosine'")
        if self.lr_schedule == "cosine" and self.lr_decay_steps <= 0:
            raise ValueError("lr_schedule='cosine' requires lr_decay_steps > 0")

    @property
    def mean_params_path(self) -> str:
        if self.smpl_mean_params_path:
            return self.smpl_mean_params_path
        return os.path.join(
            os.path.dirname(self.smpl_model_path), "neutral_smpl_mean_params.h5"
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _add_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type in ("bool", bool):
            default = f.default
            parser.add_argument(
                name,
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default,
                help=f"(default {default})",
            )
        elif f.type in ("List[str]", List[str]) or "List" in str(f.type):
            parser.add_argument(
                name, type=lambda s: s.split(","), default=None, help="comma separated"
            )
        else:
            typ = {"int": int, "float": float}.get(str(f.type), str)
            parser.add_argument(name, type=typ, default=None)


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Build a Config from CLI args (unset args keep dataclass defaults)."""
    parser = argparse.ArgumentParser(description="human_pose_estimation_tpu_torch")
    _add_args(parser)
    ns, _ = parser.parse_known_args(argv)
    cfg = Config()
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(ns, f.name, None)
        if v is not None:
            overrides[f.name] = v
    return cfg.replace(**overrides)


def run_name(cfg: Config, prefix: str = "HMR") -> str:
    """The auto-named run directory encoding the hyperparameters, as the
    JAX package names it."""
    parts = [prefix]
    if cfg.num_stage != 3:
        parts.append(f"T{cfg.num_stage}")
    parts.append(f"_{cfg.epoch}e_")
    post = ["-".join(sorted(cfg.datasets))]
    if sorted(cfg.mocap_datasets) != sorted(["CMU", "H3.6", "jointLim"]):
        post.append("-".join(cfg.mocap_datasets))
    post.append(f"Elr{cfg.generator_lr:.0e}")
    if cfg.kpr_loss_weight != 1:
        post.append(f"kp-weight{cfg.kpr_loss_weight:g}")
    if not cfg.encoder_only:
        post.append(f"Dlr{cfg.critic_lr:.0e}")
        if cfg.critic_loss_weight != 1:
            post.append(f"d-weight{cfg.critic_loss_weight:g}")
    if cfg.use_mesh_repro_loss:
        post.append("mr")
    if cfg.use_kpr_loss:
        post.append("kp")
    if cfg.trans_max != 20:
        post.append(f"transmax-{cfg.trans_max}")
    if cfg.scale_max != 1.23:
        post.append(f"scmax_{cfg.scale_max:.3g}")
    if cfg.scale_min != 0.8:
        post.append(f"scmin-{cfg.scale_min:.3g}")
    stamp = datetime.now().strftime("%b%d_%H%M")
    return "_".join(parts) + "_" + "_".join(post) + "_" + stamp


def prepare_dirs(cfg: Config, prefix: str = "HMR") -> Config:
    """Create the run/log directories and fill cfg.model_dir."""
    cfg = cfg.replace(model_dir=os.path.join(cfg.logs, run_name(cfg, prefix)))
    for path in (cfg.logs, cfg.model_dir, cfg.checkpoint_dir):
        os.makedirs(path, exist_ok=True)
    return cfg


def save_config(cfg: Config) -> str:
    """Dump the full config to params.json in the run dir."""
    if not cfg.model_dir:
        raise ValueError("cfg.model_dir is not set; call prepare_dirs first")
    path = os.path.join(cfg.model_dir, "params.json")
    with open(path, "w") as fp:
        json.dump(dataclasses.asdict(cfg), fp, indent=4, sort_keys=True)
    return path


def load_config(path: str) -> Config:
    """A Config from a params.json; keys this Config lacks are ignored."""
    with open(path) as fp:
        raw = json.load(fp)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in raw.items() if k in known})
