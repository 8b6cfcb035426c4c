"""encoder_graph_pct.vit.train: the share of the train-mode ViT's calls that
replay its CUDA graph pair (``models/encoder_graph.py``, the stochastic-depth
masks drawn up front): 100 x the traced window's ``model.encoder.graph``
spans over its ``model.encoder`` spans (``portbench/spans.py``), read as
``encoder_graph_pct.train`` reads them, in a cell whose configuration's
backbone is the ViT. None in another cell, without spans or encoder calls;
a program that runs the ViT eagerly reads 0."""
from portbench import harness as H


def read(ctx, trace):
    if ctx.config.get("backbone") != "vit_h":
        return None
    return H.load_module("metrics", "encoder_graph_pct.train").read(ctx, trace)
