"""mfu.train: the model's training operations (three times the forward,
the body model on every stage; ``portbench/flops.py``) of the images
trained in the window's untraced lead, over its seconds and the dense
bf16 peak (``readers.mfu``)."""
from portbench.readers import mfu, train_image_flops


def read(ctx, trace):
    return mfu(ctx, trace, train_image_flops(ctx))
