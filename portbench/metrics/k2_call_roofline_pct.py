"""k2_call_roofline_pct: the silhouette chamfer's value and gradient (kernel
K2) as the step calls it: the bound of the calls in the traced window,
counted from their inputs as for ``k2_roofline_pct``, over the device time
of all the work launched inside the window's ``chamfer.k2`` spans, the
four kernels and the wrapper's operations (``portbench/spans.py``)."""
from portbench.spans import chamfer_call_roofline_pct


def read(ctx, trace):
    return chamfer_call_roofline_pct(ctx, "chamfer.k2", with_grad=True)
