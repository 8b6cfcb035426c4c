"""Multi-HMR's operations and its backbone's attention bound, counted from a
configuration's widths alone, as ``flops_vit.py`` counts HMR 2.0's.

A multiply-add is two operations. Counted per image: the ViT's patch
convolution, every block's qkv, attention (q k^T and the weighted sum of
v), out projection and MLP products over 1 + patches tokens; the head's
detection logits, its queries' embedding, and per decoder layer the
self-attention among the K queries (projections and both products), the
cross-attention (the context's k and v over every patch included, and
both products) and the feed-forward; the four read-outs per slot; per slot
one body-model call (``flops.smpl_macs`` at SMPL-X's 55 joints and 486
pose features, the expression's blend shapes beside the shape's). Not
counted: LayerNorm, GELU, softmax, LayerScale, the position embedding's
resize, the ray embedding, the 6D map, the losses, the critic and the
silhouette chamfer. Training is three times the forward; nothing
recomputed is counted.

``attention_bound_s``: the attention calls of one training image, forward
and backward, by ``flops_vit``'s rule (each pass the larger of its
operations over the bf16 peak and its bytes over the memory rate): the
ViT's, one per block and head at s = 1 + patches, d = width / heads, and
the head's, per layer and head the self-attention among the K queries and
their cross-attention to the patches (a few thousandths of the ViT's).
"""
from __future__ import annotations

from typing import List, Tuple

from portbench import flops, roofline

PATCH = 14


def tokens(cfg: dict) -> int:
    """The ViT's tokens: the class token and the patches."""
    return 1 + (cfg["img_size"] // PATCH) ** 2


def vit_macs(cfg: dict) -> int:
    t, w, m = tokens(cfg), cfg["vit_width"], cfg["vit_mlp"]
    per_block = t * w * 3 * w + 2 * t * t * w + t * w * w + 2 * t * w * m
    return (t - 1) * 3 * PATCH * PATCH * w + cfg["vit_depth"] * per_block


def head_macs(cfg: dict) -> int:
    """One image's head: K slots."""
    p, k, c = tokens(cfg) - 1, cfg["person_slots"], cfg["vit_width"] + 4 * cfg["ray_bands"]
    w, inner, m = cfg["head_width"], cfg["head_heads"] * cfg["head_dim_head"], cfg["head_mlp"]
    per_layer = (
        k * w * 3 * inner + 2 * k * k * inner + k * inner * w  # self-attention among the queries
        + k * w * inner + p * c * 2 * inner + 2 * k * p * inner + k * inner * w  # cross-attention
        + 2 * k * w * m  # feed-forward
    )
    readouts = k * w * (6 * 53 + 10 + cfg["num_expression"] + 3)
    return p * cfg["vit_width"] + k * c * w + cfg["head_depth"] * per_layer + readouts


def body_macs(cfg: dict) -> int:
    """One SMPL-X call on one slot: ``flops.smpl_macs`` with the expression's
    directions counted among the shape's."""
    return flops.smpl_macs(cfg["num_verts"], cfg["num_betas"] + cfg["num_expression"], cfg["num_joints"],
                           9 * (cfg["num_joints"] - 1), cfg["num_keypoints"])


def forward_flops(cfg: dict) -> float:
    """One image's forward: the ViT, the head and a body-model call per slot."""
    return 2.0 * (vit_macs(cfg) + head_macs(cfg) + cfg["num_stage"] * cfg["person_slots"] * body_macs(cfg))


def train_flops(cfg: dict) -> float:
    return 3.0 * forward_flops(cfg)


def attention_calls(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """One image's attention calls, per head: (how many, s_q, s_k, d)."""
    t, k = tokens(cfg), cfg["person_slots"]
    head = cfg["head_depth"] * cfg["head_heads"]
    return [(cfg["vit_depth"] * cfg["vit_heads"], t, t, cfg["vit_width"] // cfg["vit_heads"]),
            (head, k, k, cfg["head_dim_head"]), (head, k, t - 1, cfg["head_dim_head"])]


def attention_bound_s(cfg: dict) -> float:
    """The least device seconds of one training image's attention calls,
    forward and backward."""
    total = 0.0
    for count, s_q, s_k, d in attention_calls(cfg):
        fwd_ops, bwd_ops = 4.0 * s_q * s_k * d, 8.0 * s_q * s_k * d
        fwd_bytes = 2.0 * (2 * s_q * d + 2 * s_k * d) + 4.0 * s_q
        bwd_bytes = 2.0 * (4 * s_q * d + 4 * s_k * d) + 4.0 * s_q
        total += count * (max(fwd_ops / roofline.PEAK_BF16_FLOPS, fwd_bytes / roofline.PEAK_HBM_BYTES)
                          + max(bwd_ops / roofline.PEAK_BF16_FLOPS, bwd_bytes / roofline.PEAK_HBM_BYTES))
    return total
