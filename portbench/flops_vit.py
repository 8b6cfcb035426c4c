"""HMR 2.0's operations and its attention's bound, counted from a
configuration's widths alone, as ``flops.py`` counts the ResNet HMR's.

A multiply-add is two operations. Counted per image: the ViT's patch
convolution, every block's qkv, attention (q k^T and the weighted sum of
v), out projection and MLP products; each head iteration's token
embedding, self- and cross-attention (their projections, the context's
k and v included, and both attention products), feed-forward and three
read-outs; per body-model call ``flops.smpl_macs``. Not counted:
LayerNorm, GELU, softmax, stochastic depth, the 6D map, the losses, the
critic and the silhouette chamfer. Training is three times the forward;
nothing recomputed is counted.

The attention calls' bound (``attention_bound_s``): per call and head,
forward 4 s_q s_k d operations against Q, K, V read and O written in
bfloat16 and the row statistics (4 bytes a query) written; backward 8 s_q
s_k d against Q, K, V, O and dO read, dQ, dK and dV written and the
statistics read (the forward's recompute of the scores not counted); each
pass the larger of its operations over the bf16 peak and its bytes over
the memory rate (``roofline.py``).
"""
from __future__ import annotations

from typing import List, Tuple

from portbench import flops, roofline

PATCH = 16


def tokens(cfg: dict) -> int:
    s = cfg["img_size"]
    return (s // PATCH) * ((s * 3 // 4) // PATCH)


def attention_calls(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """One image's attention calls, per head: (how many, s_q, s_k, d)."""
    t, iters = tokens(cfg), cfg["num_stage"]
    vit_d = cfg["vit_width"] // cfg["vit_heads"]
    head_h, head_d = cfg["head_heads"], cfg["head_dim_head"]
    return [
        (cfg["vit_depth"] * cfg["vit_heads"], t, t, vit_d),
        (iters * cfg["head_depth"] * head_h, 1, 1, head_d),  # self-attention over the one token
        (iters * cfg["head_depth"] * head_h, 1, t, head_d),  # cross-attention to the ViT's tokens
    ]


def vit_macs(cfg: dict) -> int:
    t, w, m = tokens(cfg), cfg["vit_width"], cfg["vit_mlp"]
    per_block = t * w * 3 * w + 2 * t * t * w + t * w * w + 2 * t * w * m
    return t * 3 * PATCH * PATCH * w + cfg["vit_depth"] * per_block


def head_macs(cfg: dict) -> int:
    t, w, c = tokens(cfg), cfg["head_width"], cfg["vit_width"]
    inner, m = cfg["head_heads"] * cfg["head_dim_head"], cfg["head_mlp"]
    per_layer = (
        w * 3 * inner + 2 * inner + inner * w  # self-attention over one token
        + w * inner + t * c * 2 * inner + 2 * t * inner + inner * w  # cross-attention
        + 2 * w * m  # feed-forward
    )
    return cfg["num_stage"] * (w + cfg["head_depth"] * per_layer + w * (6 * 24 + 10 + 3))


def forward_flops(cfg: dict) -> float:
    """One image's forward: the ViT, every head iteration and a body-model
    call per iteration."""
    body = flops.smpl_macs(cfg["num_verts"], cfg["num_betas"], 24, 207, cfg["num_keypoints"])
    return 2.0 * (vit_macs(cfg) + head_macs(cfg) + cfg["num_stage"] * body)


def train_flops(cfg: dict) -> float:
    return 3.0 * forward_flops(cfg)


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
