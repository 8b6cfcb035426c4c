"""mfu.mhmr.train: Multi-HMR's training operations (three times the forward
of the ViT-L/14 over the whole image, the Human Prediction Head over its
person slots and SMPL-X on every slot; ``portbench/flops_mhmr.py``) of the
images trained in the window's untraced lead, over its seconds and the
dense bf16 peak (``readers.mfu``): the whole step's share of the peak.
None for a configuration without person slots, whose operations other
readers count."""
from portbench import flops_mhmr
from portbench.readers import mfu


def read(ctx, trace):
    if not ctx.config.get("person_slots"):
        return None
    return mfu(ctx, trace, flops_mhmr.train_flops(ctx.config))
