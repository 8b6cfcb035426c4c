"""attn_roofline_pct.mhmr: the attention of Multi-HMR's ViT-L/14 over the
whole image (1 + 4096 tokens, d = 64) and of its head, forward and
backward: the least time of the attention calls of the traced window's
steps (``flops_mhmr.attention_bound_s`` a training image) over the device
time of the kernels named in ``attn_roofline_pct.mhmr.kernels.txt`` (the
calls' kernels on the card, named from a trace of ``mhmr-train-b8``). None
for a configuration without person slots, or where no such kernel ran."""
from pathlib import Path

from portbench import flops_mhmr
from portbench.readers import kernel_names

NAMES = kernel_names(str(Path(__file__).with_name("attn_roofline_pct.mhmr.kernels.txt")))


def read(ctx, trace):
    cfg = ctx.config
    if not cfg.get("person_slots"):
        return None
    seconds, _ = trace.kernel_seconds(NAMES)
    steps = trace.counts.get("steps", 0)
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * steps * cfg["batch_size"] * flops_mhmr.attention_bound_s(cfg) / seconds
