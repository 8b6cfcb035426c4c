"""Post-training int8 quantization of the ResNet encoder (inference).

Counterpart of ``human_pose_estimation_tpu/models/quantize.py``, with the
same scheme and the same names:

* BatchNorm folded into the preceding convolution (every convolution of
  the Keras topology is followed by its BN):
  ``g = gamma / sqrt(var + eps)``, ``w' = w * g``, ``b' = (b - mean) * g + beta``;
* weights: symmetric per-output-channel int8, ``s_w = max|w'| / 127``,
  ``w_q = round(w' / s_w)`` (half to even, as ``jnp.round``);
* activations: symmetric int8 with static per-tensor scales from a
  calibration batch (``calibrate_resnet``), or per-image dynamic scales
  ``max|x[n]| / 127`` when none are given;
* int32 accumulation, bf16 activations between convolutions, residual
  adds as the JAX package has them (f32 where the shortcut is
  ``x_q * s_in``), the max pool on int8.

The int8 convolution is an im2col over NHWC int8 (``Tensor.unfold`` views
and one copy, the reduction dim padded with zero columns to a multiple of
8) followed by ``torch._int_mm`` (int8 x int8 -> int32). The same code
runs on the CPU and on the card: stock torch has no int8 convolution on
CUDA, and cuBLASLt's int8 GEMM behind ``_int_mm`` wants more than 16 rows
and K and N multiples of 8, which the padding provides. The max pool is
the max over the nine strided views of the zero-padded int8 tensor, on
both devices.

Layouts: the port's ResNet keeps OIHW convolution weights
(``models/resnet.py``); ``quantize_conv`` stores ``w`` as (O, kh, kw, I)
int8, so that ``w.reshape(O, -1)`` is the GEMM's right operand transposed
and its K order (kh, kw, I) matches the im2col's, whose inner dim is the
contiguous channel dim of NHWC.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F

from .resnet import BN_EPS

_MIN_ROWS = 17  # cuBLASLt's int8 GEMM behind torch._int_mm wants more than 16 rows


def fold_conv_bn(kernel: torch.Tensor, bias: torch.Tensor, bn: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold a BatchNorm (inference form) into the preceding convolution.

    kernel: (oc, ic, kh, kw) OIHW; bias: (oc,); bn: 'scale', 'bias' (the
    affine parameters) and 'mean', 'var' (the running statistics).
    Returns {'kernel', 'bias'} of the equivalent single convolution.
    """
    g = bn["scale"] / torch.sqrt(bn["var"] + BN_EPS)
    return {"kernel": kernel * g[:, None, None, None], "bias": (bias - bn["mean"]) * g + bn["bias"]}


def quantize_conv(folded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a folded
    convolution: {'w' (oc, kh, kw, ic) int8, 's' (oc,) f32, 'b' (oc,) f32}."""
    w = folded["kernel"].float()
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
    return {"w": w_q.permute(0, 2, 3, 1).contiguous(), "s": s_w, "b": folded["bias"].float()}


def quantize_resnet(params: Mapping[str, torch.Tensor], batch_stats: Mapping[str, torch.Tensor],
                    stage_sizes: Sequence[int]) -> Dict[str, Any]:
    """Fold and quantize every conv/BN pair of a ResNet encoder
    (``models/resnet.py``) into the int8 tree ``resnet_apply_int8`` takes.

    params: the encoder's parameters by name (``dict(encoder.named_parameters())``:
    ``conv1.weight``, ``bn1.weight``, ``stage1_block1.conv_sc.bias``, ...);
    batch_stats: its running statistics by name (``bn1.running_mean``, ...).
    """

    def fold_q(prefix: str, conv: str, bn: str):
        p = f"{prefix}{conv}"
        n = f"{prefix}{bn}"
        stats = {
            "scale": params[f"{n}.weight"], "bias": params[f"{n}.bias"],
            "mean": batch_stats[f"{n}.running_mean"], "var": batch_stats[f"{n}.running_var"],
        }
        return quantize_conv(fold_conv_bn(params[f"{p}.weight"], params[f"{p}.bias"], stats))

    with torch.no_grad():
        q: Dict[str, Any] = {"conv1": fold_q("", "conv1", "bn1")}
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                name = f"stage{stage + 1}_block{block + 1}"
                blk = {c: fold_q(f"{name}.", c, f"bn{c[-1]}") for c in ("conv1", "conv2", "conv3")}
                if f"{name}.conv_sc.weight" in params:
                    blk["conv_sc"] = fold_q(f"{name}.", "conv_sc", "bn_sc")
                q[name] = blk
    return q


def _int_mm(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, with M padded by zero
    rows to the GEMM's minimum where it is smaller (the last stage of a
    small batch)."""
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(a, w_t)[:m]


def _conv_i8(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, padding: str,
             out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """int8 NHWC convolution with an (oc, kh, kw, ic) int8 kernel: im2col,
    ``torch._int_mm``, int32 accumulation. out_dtype=bfloat16 rounds the
    accumulator on write, as the JAX package's bf16 mode does; int32 keeps
    it exact. padding: 'VALID', or 'SAME' (stride 1, odd kernel)."""
    n, _, _, c = x_q.shape
    oc, kh, kw, _ = w_q.shape
    if padding == "SAME":
        x_q = F.pad(x_q, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    k = kh * kw * c
    w = w_q.reshape(oc, k)
    if kh == kw == 1:
        if stride > 1:
            x_q = x_q[:, ::stride, ::stride]
        ho, wo = x_q.shape[1:3]
        cols = x_q.reshape(n * ho * wo, c)  # a view where x_q is contiguous
    else:
        win = x_q.unfold(1, kh, stride).unfold(2, kw, stride)  # (N, Ho, Wo, C, kh, kw)
        ho, wo = win.shape[1:3]
        kp = k + (-k % 8)  # the stem's 7*7*3 = 147 -> 152: zero columns, exact
        cols = torch.empty((n * ho * wo, kp), dtype=torch.int8, device=x_q.device)
        cols[:, k:] = 0
        cols[:, :k].view(n, ho, wo, kh, kw, c).copy_(win.permute(0, 1, 2, 4, 5, 3))
        if kp != k:
            w = F.pad(w, (0, kp - k))
    y = _int_mm(cols, w.t())
    if out_dtype != torch.int32:
        y = y.to(out_dtype)
    return y.view(n, ho, wo, oc)


def _max_pool_i8(x_q: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool over the zero-padded int8 NHWC tensor, as the max of
    its nine strided views starting from -128 (the JAX reduce_window's
    init), on every device."""
    x_q = F.pad(x_q, (0, 0, 1, 1, 1, 1))
    h, w = x_q.shape[1:3]
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    out = torch.full((x_q.shape[0], ho, wo, x_q.shape[3]), -128, dtype=torch.int8, device=x_q.device)
    for i in range(3):
        for j in range(3):
            out = torch.maximum(out, x_q[:, i : i + 2 * ho - 1 : 2, j : j + 2 * wo - 1 : 2])
    return out


def resnet_apply_int8(qparams, images: torch.Tensor, stage_sizes: Sequence[int], act_scales=None,
                      observe: bool = False, conv_out_dtype: torch.dtype = torch.bfloat16):
    """Quantized ResNet encoder forward: (N, H, W, 3) in [-1, 1] -> (N, 2048)
    f32 features, the standard-stem topology of ``models/resnet.py`` (pad 3
    + VALID 7x7/2 stem, 3x3/2 max pool, v1 bottlenecks with the stride on
    the first 1x1).

    act_scales: static activation scales by site (``calibrate_resnet``);
    None runs per-image dynamic scales. observe: also return the batch-max
    dynamic scale of every site (the calibration hook). conv_out_dtype:
    torch.bfloat16 (default) rounds each accumulator on write; torch.int32
    keeps it exact.
    """
    observed = {}
    eps_dtype = torch.bfloat16  # the dequantized domain between convolutions

    def quant(x, site):
        """-> (int8 values, f32 scale): a 0-dim scale (static) or an
        (N, 1, 1, 1) per-image one (dynamic)."""
        xf = x.float()
        if observe or act_scales is None:
            s_dyn = torch.clamp_min(xf.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0, 1e-12)
            if observe:
                observed[site] = s_dyn.max()
        s = act_scales[site] if act_scales is not None else s_dyn
        x_q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        return x_q, s

    def deq(y, s_x, layer):
        return (y.float() * (s_x * layer["s"]) + layer["b"]).to(eps_dtype)

    x = images.float()
    x_q, s_in = quant(F.pad(x, (0, 0, 3, 3, 3, 3)), "stem_in")  # zero pad: 0.0 quantizes to 0
    y = deq(_conv_i8(x_q, qparams["conv1"]["w"], 2, "VALID", conv_out_dtype), s_in, qparams["conv1"])
    x_q, s_in = quant(torch.relu(y), "stem_out")
    # the pool on int8: dequantization is monotonic and post-relu values
    # are >= 0, so the int8 max with zero padding is the Keras pool's
    x_q = _max_pool_i8(x_q)

    for stage, num_blocks in enumerate(stage_sizes):
        for block in range(num_blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            name = f"stage{stage + 1}_block{block + 1}"
            blk = qparams[name]
            if "conv_sc" in blk:
                shortcut = deq(_conv_i8(x_q, blk["conv_sc"]["w"], stride, "VALID", conv_out_dtype), s_in,
                               blk["conv_sc"])
            else:
                shortcut = x_q.float() * s_in
            y = deq(_conv_i8(x_q, blk["conv1"]["w"], stride, "VALID", conv_out_dtype), s_in, blk["conv1"])
            y_q, s_y = quant(torch.relu(y), f"{name}/y1")
            y = deq(_conv_i8(y_q, blk["conv2"]["w"], 1, "SAME", conv_out_dtype), s_y, blk["conv2"])
            y_q, s_y = quant(torch.relu(y), f"{name}/y2")
            y = deq(_conv_i8(y_q, blk["conv3"]["w"], 1, "VALID", conv_out_dtype), s_y, blk["conv3"])
            x_q, s_in = quant(torch.relu(y + shortcut), f"{name}/out")

    feats = (x_q.float() * s_in).mean(dim=(1, 2))
    if observe:
        return feats, observed
    return feats


def calibrate_resnet(qparams, images: torch.Tensor, stage_sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Static activation scales from a calibration batch: the dynamic-scale
    forward once, recording the batch-max scale of every activation site
    (0-dim f32 tensors on the images' device)."""
    with torch.no_grad():
        _, observed = resnet_apply_int8(qparams, images, stage_sizes, act_scales=None, observe=True)
    return observed
