"""k2_roofline_pct: the silhouette chamfer's value and gradient (kernel K2,
``ops/cuda_chamfer.ChamferFunction``): the bound of the calls in the
traced window, counted from their inputs (``portbench/roofline.py``), over
the device time of the kernels named in ``k2_roofline_pct.kernels.txt``.
The port has no profiler range on its chamfer entry points yet, so the
kernels are found by name."""
from pathlib import Path

from portbench.readers import chamfer_roofline_pct, kernel_names

NAMES = kernel_names(str(Path(__file__).with_name("k2_roofline_pct.kernels.txt")))


def read(ctx, trace):
    return chamfer_roofline_pct(ctx, trace, NAMES, with_grad=True)
