"""mfu.vit.train: HMR 2.0's training operations (three times the forward of
the ViT, the head and the body model; ``portbench/flops_vit.py``) of the
images trained in the window's untraced lead, over its seconds and the
dense bf16 peak (``readers.mfu``). None for a configuration without the
ViT, whose operations ``mfu.train`` counts."""
from portbench import flops_vit
from portbench.readers import mfu


def read(ctx, trace):
    if ctx.config.get("backbone") != "vit_h":
        return None
    return mfu(ctx, trace, flops_vit.train_flops(ctx.config))
