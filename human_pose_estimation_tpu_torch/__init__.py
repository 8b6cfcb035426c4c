"""human_pose_estimation_tpu_torch — the PyTorch / CUDA port of
``human_pose_estimation_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout and
names (``core/smpl.py`` here is the counterpart of ``core/smpl.py`` there)
and imports nothing of it. Plain tensor code is PyTorch; the Pallas TPU
kernels become hand-written CUDA kernels under ``csrc/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is unavailable and the caller did not ask for the CPU
    explicitly — a run meant for the card never moves to the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 when it already is: the cast at the end of
    an autocast region (bf16 -> f32) that keeps an f64 computation f64."""
    return x if x.dtype == torch.float64 else x.float()


def pin_f32_numerics() -> None:
    """Full-f32 convolutions and matmuls on the card.

    cuDNN runs f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits and perturbs the encoder; every f32 comparison with the
    JAX reference or between the kernel and its plain version sets both
    flags off first.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
