"""attn_roofline_pct: the attention of HMR 2.0's ViT and head, forward and
backward: the least time of the attention calls of the traced window's
steps (``flops_vit.attention_bound_s`` a training image, the larger of
operations and bytes per pass) over the device time of the kernels named
in ``attn_roofline_pct.kernels.txt`` (``F.scaled_dot_product_attention``'s
kernels on the card, named from a trace of ``vith-train-b48``). None for
a configuration without the ViT, or where no such kernel ran."""
from pathlib import Path

from portbench import flops_vit
from portbench.readers import kernel_names

NAMES = kernel_names(str(Path(__file__).with_name("attn_roofline_pct.kernels.txt")))


def read(ctx, trace):
    cfg = ctx.config
    if cfg.get("backbone") != "vit_h":
        return None
    seconds, _ = trace.kernel_seconds(NAMES)
    steps = trace.counts.get("steps", 0)
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * steps * cfg["batch_size"] * flops_vit.attention_bound_s(cfg) / seconds
