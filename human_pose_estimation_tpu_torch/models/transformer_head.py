"""HMR 2.0's ``SMPLTransformerDecoderHead`` (Goel et al., ICCV 2023,
arXiv:2305.20086; ``hmr2/models/heads/smpl_head.py`` and
``hmr2/models/components/pose_transformer.py`` in
github.com/shubham-goel/4D-Humans), the port's own module.

One zero token of width 1 is embedded (Linear(1, width)) and a learned
position (1, 1, width) added; ``depth`` pre-LN layers then refine it, each
``x += self_attn(LN(x))``, ``x += cross_attn(LN(x), context)``,
``x += ff(LN(x))``:

* self-attention: ``heads`` x ``dim_head``, qkv without bias, out
  projection with bias;
* cross-attention to the backbone's tokens (not normalised here): q from
  the token, k and v from the context, both without bias, out projection
  with bias;
* feed-forward: width -> mlp, exact GELU, -> width; dropout 0; LayerNorm
  eps 1e-5 (``nn.LayerNorm``'s default, as published).

Attention runs through ``F.scaled_dot_product_attention`` at scale
1 / sqrt(dim_head). The token is read out by three linear layers,
``decpose`` (24 joints x 6D), ``decshape`` (10) and ``deccam`` (3), each
added to the estimate it refines: the mean on the first iteration.

HMR 2.0's widths: depth 6, width 1024, 8 heads of 64, MLP 1024, context
1280 (ViT-H). The port keeps its 85-d mean theta [cam | axis-angle pose |
shape] as the trained leaf and turns its pose into the 6D form here
(``initial``): the first two columns of each mean rotation.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rotations import rodrigues, rot6d_to_rotmat, rotmat_to_rot6d
from ..utils.tracing import span

NUM_JOINTS = 24
POSE_6D = 6 * NUM_JOINTS
LN_EPS = 1e-5


class HeadShape(NamedTuple):
    depth: int
    width: int
    heads: int
    dim_head: int
    mlp: int


HMR2_HEAD = HeadShape(depth=6, width=1024, heads=8, dim_head=64, mlp=1024)

# (cam (N, 3), 6D pose (N, 144), shape (N, 10))
Estimate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, Tq, H*D), (N, Tk, H*D) x2 -> (N, Tq, H*D): multi-head attention."""
    n, tq, inner = q.shape
    split = lambda t: t.reshape(n, t.shape[1], heads, inner // heads).transpose(1, 2)  # noqa: E731
    o = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return o.transpose(1, 2).reshape(n, tq, inner)


class DecoderLayer(nn.Module):
    def __init__(self, shape: HeadShape, context_dim: int):
        super().__init__()
        inner = shape.heads * shape.dim_head
        self.heads = shape.heads
        self.self_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.self_qkv = nn.Linear(shape.width, 3 * inner, bias=False)
        self.self_out = nn.Linear(inner, shape.width)
        self.cross_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.cross_q = nn.Linear(shape.width, inner, bias=False)
        self.cross_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.cross_out = nn.Linear(inner, shape.width)
        self.ff_norm = nn.LayerNorm(shape.width, eps=LN_EPS)
        self.ff1 = nn.Linear(shape.width, shape.mlp)
        self.ff2 = nn.Linear(shape.mlp, shape.width)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        q, k, v = self.self_qkv(self.self_norm(x)).chunk(3, dim=-1)
        x = x + self.self_out(_attend(q, k, v, self.heads))
        k, v = self.cross_kv(context).chunk(2, dim=-1)
        x = x + self.cross_out(_attend(self.cross_q(self.cross_norm(x)), k, v, self.heads))
        return x + self.ff2(F.gelu(self.ff1(self.ff_norm(x))))


class TransformerDecoderHead(nn.Module):
    def __init__(self, context_dim: int = 1280, shape: HeadShape = HMR2_HEAD):
        super().__init__()
        self.shape = shape
        self.token_embedding = nn.Linear(1, shape.width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, shape.width))
        self.layers = nn.ModuleList([DecoderLayer(shape, context_dim) for _ in range(shape.depth)])
        self.decpose = nn.Linear(shape.width, POSE_6D)
        self.decshape = nn.Linear(shape.width, 10)
        self.deccam = nn.Linear(shape.width, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Drawn from ``generator`` on the module's device: glorot-uniform
        dense layers (the port's regressor initialiser), the published
        ``INIT_DECODER_XAVIER`` read-outs (glorot uniform at gain 0.01, so
        that a fresh head starts at the mean), zero biases, LayerNorm 1 / 0,
        the position as published (standard normal)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                gain = 0.01 if m in (self.decpose, self.decshape, self.deccam) else 1.0
                nn.init.xavier_uniform_(m.weight, gain=gain, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.pos_embedding, generator=generator)

    @staticmethod
    def initial(mean_theta: torch.Tensor, n: int) -> Estimate:
        """The first estimate from the (1, 85) mean theta: (cam, its pose's
        rotations in 6D, shape), each expanded to ``n`` rows."""
        cam, pose, shape = mean_theta[:, :3], mean_theta[:, 3:75], mean_theta[:, 75:]
        pose6d = rotmat_to_rot6d(rodrigues(pose.reshape(-1, NUM_JOINTS, 3))).reshape(-1, POSE_6D)
        return cam.expand(n, -1), pose6d.expand(n, -1), shape.expand(n, -1)

    def forward(self, context: torch.Tensor, estimate: Estimate) -> Estimate:
        """context (N, tokens, context_dim); ``estimate`` (cam, pose6d,
        shape) -> the refined estimate."""
        cam, pose6d, shape = estimate
        token = context.new_zeros(context.shape[0], 1, 1)
        x = self.token_embedding(token) + self.pos_embedding
        for layer in self.layers:
            x = layer(x, context)
        x = x[:, 0]
        return self.deccam(x) + cam, self.decpose(x) + pose6d, self.decshape(x) + shape

    def step(self, context, estimate, first, last, generator, autocast):
        """One iteration from ``estimate`` (the mean theta on the ``first``,
        made ``initial`` inside the span): (the refined estimate, (theta,
        cam, 6D pose, shape), the body model's pose: the 6D map's matrices).
        ``autocast()`` covers the decoder alone; the head draws nothing."""
        n = context.shape[0]
        with span("model.head"):
            if first:
                estimate = self.initial(estimate, n)
            with autocast():
                estimate = self(context, estimate)
            cam, pose6d, shape = estimate
            rotations = rot6d_to_rotmat(pose6d.reshape(n, NUM_JOINTS, 6))
        theta = torch.cat([cam, pose6d, shape], dim=-1)
        return estimate, (theta, cam, pose6d, shape), {"theta": None, "rotations": rotations}
