"""The measures by which the program's outputs are held against the
reference's."""
from __future__ import annotations

import contextlib

import torch


def rel_gap(got, want) -> float:
    """|got - want| / |want| of two numbers."""
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-300)


def checks(numbers, limits):
    """The compared numbers: those the cell's limits name."""
    from portbench.harness import Check

    return [Check(k, numbers[k], v) for k, v in limits.items()]


@contextlib.contextmanager
def f32():
    """The reference's precision: float32 matrix products and convolutions
    with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
