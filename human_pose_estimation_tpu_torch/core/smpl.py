"""SMPL body model in PyTorch.

Counterpart of ``human_pose_estimation_tpu/core/smpl.py``: shape
blendshapes, joint regression, pose blendshapes, forward kinematics down
the 24-joint tree as (R, t) pairs, linear blend skinning, and the
cocoplus / LSP keypoint regressor. ``SMPLModel`` is a plain container of
tensors; the loaders read the official pickle and the npz layout with
numpy only.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .rotations import rodrigues

NUM_JOINTS = 24
NUM_BETAS = 10
POSE_FEATURE_DIM = 207  # 23 * 9

# Standard SMPL kinematic-tree parents (index 0 is the root; its entry is
# never dereferenced) — kintree_table[0] of every released SMPL model.
SMPL_PARENTS = (
    0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)

_TENSOR_FIELDS = (
    "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "joint_regressor",
)


def _dense(x: Any) -> np.ndarray:
    """Convert possibly-sparse / chumpy-wrapped arrays to plain numpy."""
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    elif hasattr(x, "r"):  # chumpy
        x = np.asarray(x.r)
    return np.asarray(x)


@dataclasses.dataclass
class SMPLModel:
    """SMPL template assets. V = vertices (6890 for real SMPL), K = 24
    joints, J = 19 cocoplus keypoints."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (NUM_BETAS, V*3)
    posedirs: torch.Tensor  # (POSE_FEATURE_DIM, V*3)
    j_regressor: torch.Tensor  # (V, K)
    lbs_weights: torch.Tensor  # (V, K)
    joint_regressor: torch.Tensor  # (V, 19) cocoplus keypoint regressor
    parents: Tuple[int, ...] = SMPL_PARENTS
    faces: Optional[np.ndarray] = None

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @classmethod
    def from_arrays(cls, parents=SMPL_PARENTS, faces=None, **arrays) -> "SMPLModel":
        """Build from numpy arrays (f32 CPU tensors)."""
        tensors = {
            k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.float32))
            for k in _TENSOR_FIELDS
        }
        return cls(**tensors, parents=tuple(int(p) for p in parents), faces=faces)

    def to(self, device, dtype=None) -> "SMPLModel":
        return dataclasses.replace(self, **{k: getattr(self, k).to(device, dtype) for k in _TENSOR_FIELDS})


@dataclasses.dataclass
class SMPLOutput:
    verts: torch.Tensor  # (N, V, 3) posed, skinned vertices
    joints: torch.Tensor  # (N, 19|14, 3) regressed keypoints
    rotations: torch.Tensor  # (N, 24, 3, 3) per-joint rotation matrices
    joints_smpl: torch.Tensor  # (N, 24, 3) posed kinematic-tree joints


def load_model(path: str) -> SMPLModel:
    """Load an SMPL asset from the official pickle or from npz: v_template,
    shapedirs (V,3,10), posedirs (V,3,207), J_regressor (24,V sparse),
    weights (V,24), cocoplus_regressor (19,V sparse), kintree_table,
    optional f."""
    if path.endswith(".npz"):
        return load_model_npz(path)
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    num_betas = int(_dense(dd["shapedirs"]).shape[-1])
    parents = tuple(int(p) for p in _dense(dd["kintree_table"])[0])
    # the root's parent is stored as uint32(-1); normalize to 0
    parents = (0,) + parents[1:]
    return SMPLModel.from_arrays(
        v_template=_dense(dd["v_template"]),
        shapedirs=_dense(dd["shapedirs"]).reshape(-1, num_betas).T,
        posedirs=_dense(dd["posedirs"]).reshape(-1, POSE_FEATURE_DIM).T,
        j_regressor=_dense(dd["J_regressor"]).T,  # (V, 24)
        lbs_weights=_dense(dd["weights"]),
        joint_regressor=_dense(dd["cocoplus_regressor"]).T,  # (V, 19)
        parents=parents,
        faces=_dense(dd["f"]).astype(np.int32) if "f" in dd else None,
    )


def save_model_npz(model: SMPLModel, path: str) -> None:
    """Write ``model`` in the npz layout ``load_model_npz`` reads (the JAX
    package's layout: f32 arrays, int32 parents, (0, 3) faces when there
    are none)."""
    np.savez(
        path,
        **{k: getattr(model, k).detach().cpu().numpy() for k in _TENSOR_FIELDS},
        parents=np.asarray(model.parents, dtype=np.int32),
        faces=model.faces if model.faces is not None else np.zeros((0, 3), np.int32),
    )


def load_model_npz(path: str) -> SMPLModel:
    z = np.load(path)
    faces = z["faces"]
    return SMPLModel.from_arrays(
        **{k: z[k] for k in _TENSOR_FIELDS},
        parents=z["parents"],
        faces=faces if faces.size else None,
    )


def global_rigid_transform(
    rotations: torch.Tensor, joints: torch.Tensor, parents: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kinematics as (R, t) pairs.

    rotations (N, K, 3, 3) local rotations, joints (N, K, 3) rest joints ->
    (posed joints (N, K, 3), world R (N, K, 3, 3), skin_t (N, K, 3)) with
    ``skin_t = t_world - R_world @ J_rest``, the translation of the
    relative skinning transform.
    """
    world_r = [rotations[:, 0]]
    world_t = [joints[:, 0]]
    for k in range(1, len(parents)):
        p = parents[k]
        bone = joints[:, k] - joints[:, p]
        world_r.append(world_r[p] @ rotations[:, k])
        world_t.append(world_t[p] + (world_r[p] @ bone[..., None])[..., 0])
    world_r = torch.stack(world_r, dim=1)  # (N, K, 3, 3)
    world_t = torch.stack(world_t, dim=1)  # (N, K, 3)
    skin_t = world_t - (world_r @ joints[..., None])[..., 0]
    return world_t, world_r, skin_t


def smpl_forward(
    model: SMPLModel,
    beta: torch.Tensor,
    theta: torch.Tensor,
    joint_type: str = "cocoplus",
) -> SMPLOutput:
    """Batched SMPL forward: beta (N, 10), theta (N, 72) axis-angle ->
    verts (N, V, 3), joints (N, 19|14, 3), rotations (N, 24, 3, 3),
    joints_smpl (N, 24, 3). joint_type: 'cocoplus' (19) or 'lsp' (14)."""
    if joint_type not in ("cocoplus", "lsp"):
        raise ValueError(f"joint_type must be 'cocoplus' or 'lsp', got {joint_type!r}")
    n = beta.shape[0]
    v = model.num_verts

    # 1. shape blendshapes and the shape-dependent rest joints
    v_shaped = (beta @ model.shapedirs).reshape(n, v, 3) + model.v_template
    joints_rest = torch.einsum("nvc,vk->nkc", v_shaped, model.j_regressor)

    # 2. per-joint rotations and pose blendshapes
    rotations = rodrigues(theta.reshape(n, NUM_JOINTS, 3))
    eye = torch.eye(3, dtype=rotations.dtype, device=rotations.device)
    pose_feature = (rotations[:, 1:] - eye).reshape(n, POSE_FEATURE_DIM)
    v_posed = (pose_feature @ model.posedirs).reshape(n, v, 3) + v_shaped

    # 3. forward kinematics
    posed_joints, world_r, skin_t = global_rigid_transform(
        rotations, joints_rest, model.parents
    )

    # 4. linear blend skinning: blend the flattened per-joint (R | t) with
    #    the LBS weights in ONE (V,K)x(K,12) product per sample; blending R
    #    and t separately as (N,V,3,3) products builds a multi-GB
    #    intermediate at batch >= 128.
    a_flat = torch.cat([world_r.reshape(n, NUM_JOINTS, 9), skin_t], dim=-1)  # (N, K, 12)
    blended = model.lbs_weights @ a_flat  # (N, V, 12)
    r_blend = blended[..., :9].reshape(n, v, 3, 3)
    verts = (r_blend * v_posed[:, :, None, :]).sum(dim=-1) + blended[..., 9:]

    # 5. keypoint regression (cocoplus 19 / LSP 14)
    regressor = model.joint_regressor
    if joint_type == "lsp":
        regressor = regressor[:, :14]
    joints = torch.einsum("nvc,vj->njc", verts, regressor)

    return SMPLOutput(verts=verts, joints=joints, rotations=rotations, joints_smpl=posed_joints)
