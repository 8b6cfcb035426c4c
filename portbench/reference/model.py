"""The plain float32 reference of the HMR network: ResNet-50 v1 (the Keras
layout: a bias on every convolution, the stride on the first 1x1 of a
downsampling block, BatchNorm eps 1.001e-5 whose train mode uses the batch
mean and the biased variance), three IEF stages of 1024 units with dropout
on the last stage, the SMPL body model (shape and pose blend shapes,
forward kinematics, linear blend skinning, a keypoint regressor), the
weak-perspective projection, the KCS and the three-stream critic.

Written from the published descriptions (He et al. 2016; Kanazawa et al.
2018; Loper et al. 2015; Wandt and Rosenhahn 2019) in functional form over
a dict of tensors whose names are those of the state dicts that the
benchmark loads into the system under test. It imports nothing of the
system under test. Every function computes in the dtype of its inputs;
the benchmark runs it in float32 with TF32 off.

``quant``, where a function takes it, rounds every tensor that a
bfloat16 computation of the encoder and the regressor holds in its low
precision: both operands and the result of every convolution and dense
product, BatchNorm's output, each residual sum and the pooled features.
The benchmark's control puts a precision below bfloat16 there.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1.001e-5
BN_MOMENTUM = 0.01  # running = 0.99 * running + 0.01 * batch
THETA_DIM = 85  # [cam 3 | pose 72 | shape 10]
NUM_JOINTS = 24
POSE_FEATURE_DIM = 207
DROPOUT_KEEP = 0.5
# SMPL's kinematic tree (kintree_table[0] of every released model)
SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
# the 14-joint LSP skeleton's 13 bones: bone b runs from joint b to _FAR[b]
_FAR = (1, 2, 8, 9, 3, 4, 7, 8, 12, 12, 9, 10, 13)

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


# --------------------------------------------------------------- shapes
def resnet_spec(stage_sizes: Sequence[int], prefix: str = "encoder.") -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the encoder: kind is 'conv'
    (OIHW weight), 'bias', 'bn_w', 'bn_b', 'bn_mean', 'bn_var' or
    'bn_count'."""
    out = []

    def conv(name, cin, cout, k):
        out.extend([(f"{prefix}{name}.weight", (cout, cin, k, k), "conv"), (f"{prefix}{name}.bias", (cout,), "bias")])

    def bn(name, c):
        out.extend([
            (f"{prefix}{name}.weight", (c,), "bn_w"), (f"{prefix}{name}.bias", (c,), "bn_b"),
            (f"{prefix}{name}.running_mean", (c,), "bn_mean"), (f"{prefix}{name}.running_var", (c,), "bn_var"),
            (f"{prefix}{name}.num_batches_tracked", (), "bn_count"),
        ])

    conv("conv1", 3, 64, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate(stage_sizes):
        f = 64 * 2**s
        for b in range(blocks):
            name = f"stage{s + 1}_block{b + 1}"
            if b == 0:
                conv(f"{name}.conv_sc", cin, 4 * f, 1)
                bn(f"{name}.bn_sc", 4 * f)
            conv(f"{name}.conv1", cin, f, 1)
            bn(f"{name}.bn1", f)
            conv(f"{name}.conv2", f, f, 3)
            bn(f"{name}.bn2", f)
            conv(f"{name}.conv3", f, 4 * f, 1)
            bn(f"{name}.bn3", 4 * f)
            cin = 4 * f
    return out


def regressor_spec(feature_dim: int, hidden: int, prefix: str = "regressor.") -> List[Tuple[str, tuple, str]]:
    """The IEF regressor's dense layers: (features + 85) -> hidden ->
    hidden -> 85; kinds 'dense' (out, in), 'dense_out' (the last layer) and
    'bias'."""
    return [
        (f"{prefix}fc1.weight", (hidden, feature_dim + THETA_DIM), "dense"), (f"{prefix}fc1.bias", (hidden,), "bias"),
        (f"{prefix}fc2.weight", (hidden, hidden), "dense"), (f"{prefix}fc2.bias", (hidden,), "bias"),
        (f"{prefix}out.weight", (THETA_DIM, hidden), "dense_out"), (f"{prefix}out.bias", (THETA_DIM,), "bias"),
    ]


def critic_spec() -> List[Tuple[str, tuple, str]]:
    """The critic's dense layers (out, in): the KCS and joint streams of
    100 units joined to one score, shapes 10 -> 10 -> 5 -> 1, rotations
    207 -> 300 -> 100 -> 1."""
    layers = (
        ("kcs_dense", 169, 100), ("joints_dense", 42, 100), ("combined_dense", 200, 1),
        ("shapes_dense_1", 10, 10), ("shapes_dense_2", 10, 5), ("shapes_dense_3", 5, 1),
        ("rotation_dense_1", 207, 300), ("rotation_dense_2", 300, 100), ("rotation_dense_3", 100, 1),
    )
    out = []
    for name, fin, fout in layers:
        out.extend([(f"{name}.weight", (fout, fin), "dense"), (f"{name}.bias", (fout,), "bias")])
    return out


def encoder_feature_dim(stage_sizes: Sequence[int]) -> int:
    return 64 * 2 ** (len(stage_sizes) - 1) * 4


# --------------------------------------------------------------- encoder
def _conv(x, p, name, stride=1, padding=0, quant: Quant = None):
    y = F.conv2d(_q(quant, x), _q(quant, p[name + ".weight"]), p[name + ".bias"], stride=stride, padding=padding)
    return _q(quant, y)


def _bn(x, p, bufs, name, train: bool, momentum: float = BN_MOMENTUM, quant: Quant = None):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        if bufs is not None:
            rm, rv = name + ".running_mean", name + ".running_var"
            bufs[rm] = (1.0 - momentum) * bufs[rm] + momentum * mean.detach()
            bufs[rv] = (1.0 - momentum) * bufs[rv] + momentum * var.detach()
    else:
        mean, var = bufs[name + ".running_mean"], bufs[name + ".running_var"]
    scale = torch.rsqrt(var + BN_EPS) * w
    return _q(quant, (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None])


def resnet(images: torch.Tensor, p: Params, bufs: Params, stage_sizes: Sequence[int], train: bool,
           quant: Quant = None, momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """images (N, H, W, 3) in [-1, 1] -> (N, features) after the global
    average pool. In train mode BatchNorm moves ``bufs`` towards the batch's
    statistics by ``momentum``."""
    e = "encoder."
    x = images.permute(0, 3, 1, 2)
    bn = lambda y, name: _bn(y, p, bufs, name, train, momentum, quant)  # noqa: E731
    x = torch.relu(bn(_conv(x, p, e + "conv1", 2, 3, quant), e + "bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            n = f"{e}stage{s + 1}_block{b + 1}."
            stride = 2 if (b == 0 and s > 0) else 1
            sc = bn(_conv(x, p, n + "conv_sc", stride, 0, quant), n + "bn_sc") if b == 0 else x
            y = torch.relu(bn(_conv(x, p, n + "conv1", stride, 0, quant), n + "bn1"))
            y = torch.relu(bn(_conv(y, p, n + "conv2", 1, 1, quant), n + "bn2"))
            y = bn(_conv(y, p, n + "conv3", 1, 0, quant), n + "bn3")
            x = torch.relu(_q(quant, y + sc))
    return _q(quant, x.mean(dim=(2, 3)))


# -------------------------------------------------------------- regressor
def _dense(x, p, name, quant: Quant = None):
    return _q(quant, F.linear(_q(quant, x), _q(quant, p[name + ".weight"]), p[name + ".bias"]))


def _dropout(x, generator):
    """Keep with probability 0.5 and scale by 2; one uniform per element
    from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < DROPOUT_KEEP
    return torch.where(keep, x / DROPOUT_KEEP, torch.zeros_like(x))


def ief_stage(features, theta, p: Params, train: bool, generator, quant: Quant = None):
    """One IEF stage: concat(features, theta) -> delta theta; dropout after
    both hidden layers in train mode."""
    x = torch.relu(_dense(torch.cat([features, theta], dim=-1), p, "regressor.fc1", quant))
    if train:
        x = _dropout(x, generator)
    x = torch.relu(_dense(x, p, "regressor.fc2", quant))
    if train:
        x = _dropout(x, generator)
    return _dense(x, p, "regressor.out", quant)


# ------------------------------------------------------------------ SMPL
class Body(NamedTuple):
    """SMPL's tensors: v_template (V, 3), shapedirs (10, 3V), posedirs
    (207, 3V), j_regressor (V, 24), lbs_weights (V, 24), joint_regressor
    (V, 19) (the cocoplus keypoints)."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    joint_regressor: torch.Tensor


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def rodrigues(theta):
    """Axis-angle (..., 3) -> (..., 3, 3); the angle is |theta + 1e-8|, as
    the reference implementation of HMR computes it."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=-1, keepdim=True)
    axis = theta / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return cos * eye + (1.0 - cos) * axis[..., :, None] * axis[..., None, :] + sin * _skew(axis)


def smpl(body: Body, beta, pose, joints: str = "lsp"):
    """(verts (N, V, 3), keypoints (N, 14|19, 3), rotations (N, 24, 3, 3))."""
    n, v = beta.shape[0], body.v_template.shape[0]
    v_shaped = (beta @ body.shapedirs).reshape(n, v, 3) + body.v_template
    rest = torch.einsum("nvc,vk->nkc", v_shaped, body.j_regressor)
    rot = rodrigues(pose.reshape(n, NUM_JOINTS, 3))
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = ((rot[:, 1:] - eye).reshape(n, POSE_FEATURE_DIM) @ body.posedirs).reshape(n, v, 3) + v_shaped
    world_r, world_t = [rot[:, 0]], [rest[:, 0]]
    for k in range(1, NUM_JOINTS):
        q = SMPL_PARENTS[k]
        world_t.append(world_t[q] + (world_r[q] @ (rest[:, k] - rest[:, q])[..., None])[..., 0])
        world_r.append(world_r[q] @ rot[:, k])
    world_r, world_t = torch.stack(world_r, 1), torch.stack(world_t, 1)
    skin_t = world_t - (world_r @ rest[..., None])[..., 0]
    a = torch.cat([world_r.reshape(n, NUM_JOINTS, 9), skin_t], -1)  # (N, 24, 12)
    blended = body.lbs_weights @ a  # (N, V, 12)
    verts = (blended[..., :9].reshape(n, v, 3, 3) * v_posed[:, :, None, :]).sum(-1) + blended[..., 9:]
    reg = body.joint_regressor[:, :14] if joints == "lsp" else body.joint_regressor
    return verts, torch.einsum("nvc,vj->njc", verts, reg), rot


def project(points, cam):
    """Weak perspective: s * (X[..., :2] + [tx, ty])."""
    cam = cam.reshape(-1, 1, 3)
    return cam[..., :1] * (points[..., :2] + cam[..., 1:])


class Stage(NamedTuple):
    theta: torch.Tensor
    cam: torch.Tensor
    shape: torch.Tensor
    verts: torch.Tensor
    joints: torch.Tensor
    rotations: torch.Tensor  # (N, 23, 3, 3), the root left out
    kp2d: torch.Tensor


def hmr(images, mean_theta, p: Params, bufs: Params, body: Body, stage_sizes, num_stage: int = 3,
        train: bool = False, generator=None, smpl_stages: str = "all", quant: Quant = None) -> List[Optional[Stage]]:
    """The HMR forward: encoder, ``num_stage`` IEF stages from
    ``mean_theta`` (1, 85), the body model on every stage (or on the last
    with ``smpl_stages='last'``, the others None)."""
    features = resnet(images, p, bufs, stage_sizes, train, quant)
    theta = mean_theta.expand(images.shape[0], -1)
    out = []
    for s in range(num_stage):
        last = s == num_stage - 1
        theta = theta + ief_stage(features, theta, p, train and last, generator, quant)
        if smpl_stages == "all" or last:
            cam, pose, shape = theta[:, :3], theta[:, 3:75], theta[:, 75:]
            verts, joints, rot = smpl(body, shape, pose, "lsp")
            out.append(Stage(theta, cam, shape, verts, joints, rot[:, 1:], project(joints, cam)))
        else:
            out.append(None)
    return out


# ----------------------------------------------------------------- critic
def bone_matrix(device, dtype=torch.float32) -> torch.Tensor:
    c = torch.zeros(14, 13, dtype=dtype)
    c[torch.arange(13), torch.arange(13)] = 1.0
    c[torch.tensor(_FAR), torch.arange(13)] = -1.0
    return c.to(device)


def kcs(joints, c):
    b = torch.einsum("nkc,kb->nbc", joints[:, :14], c)
    return b @ b.transpose(1, 2)


def critic(cp: Params, kcs_m, joints, shapes, rotations):
    """(N, 3) scores [skeleton, shape, rotation]; leaky-relu slope 0.2."""
    n = kcs_m.shape[0]
    lr = lambda x: F.leaky_relu(x, 0.2)  # noqa: E731
    skel = _dense(torch.cat([lr(_dense(kcs_m.reshape(n, -1), cp, "kcs_dense")),
                             lr(_dense(joints.reshape(n, -1), cp, "joints_dense"))], -1), cp, "combined_dense")
    s = torch.relu(_dense(torch.relu(_dense(shapes, cp, "shapes_dense_1")), cp, "shapes_dense_2"))
    r = lr(_dense(lr(_dense(rotations.reshape(n, -1), cp, "rotation_dense_1")), cp, "rotation_dense_2"))
    return torch.cat([skel, _dense(s, cp, "shapes_dense_3"), _dense(r, cp, "rotation_dense_3")], -1)


def fan_in(shape: tuple) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else 1
