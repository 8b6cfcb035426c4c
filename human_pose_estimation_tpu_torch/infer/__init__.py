"""Inference layer: Predictor, the serving microbatcher, export.

The names are imported on first use, so that the artifact loader
(``infer.export.ExportedPredictor``) can be imported without the model code.
"""
import importlib

__all__ = ["Predictor", "BatchingPredictor", "ExportedPredictor", "export_predictor"]

_MODULE = {
    "Predictor": ".predictor",
    "BatchingPredictor": ".serving",
    "ExportedPredictor": ".export",
    "export_predictor": ".export",
}


def __getattr__(name):
    if name in _MODULE:
        return getattr(importlib.import_module(_MODULE[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
