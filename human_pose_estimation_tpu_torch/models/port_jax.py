"""Weight bridge: the JAX package's variables -> this package's state.

Takes the Flax trees as nested dicts of NUMPY arrays (the caller converts,
e.g. with ``jax.tree.map(np.asarray, variables)``), so this module imports
no JAX. Layout changes:

* Conv kernel HWIO -> ``Conv2d.weight`` OIHW;
* Dense kernel (in, out) -> ``Linear.weight`` (out, in);
* BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (plus a zero ``num_batches_tracked``).

Module names match the Flax names one to one (models/resnet.py), so the
walk is generic.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "hmr_state_dict", "mean_theta"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def flax_to_state_dict(
    params: Mapping, batch_stats: Optional[Mapping] = None, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """Walk a Flax params tree (and its batch_stats) into torch names;
    the critic's params map straight to models.critic.Critic."""
    out: Dict[str, torch.Tensor] = {}
    stats = batch_stats or {}
    for name, node in params.items():
        key = f"{prefix}{name}"
        if "kernel" in node:
            kernel = np.asarray(node["kernel"])
            if kernel.ndim == 4:  # conv HWIO -> OIHW
                out[f"{key}.weight"] = _t(kernel.transpose(3, 2, 0, 1))
            elif kernel.ndim == 2:  # dense (in, out) -> (out, in)
                out[f"{key}.weight"] = _t(kernel.T)
            else:
                raise ValueError(f"{key}: unexpected kernel rank {kernel.ndim}")
            if "bias" in node:
                out[f"{key}.bias"] = _t(node["bias"])
        elif "scale" in node:  # BatchNorm
            out[f"{key}.weight"] = _t(node["scale"])
            out[f"{key}.bias"] = _t(node["bias"])
            out[f"{key}.running_mean"] = _t(stats[name]["mean"])
            out[f"{key}.running_var"] = _t(stats[name]["var"])
            out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            out.update(flax_to_state_dict(node, stats.get(name), prefix=f"{key}."))
    return out


def hmr_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': {'encoder', 'regressor'}, 'batch_stats': {'encoder'}} ->
    the state dict of models.hmr.HMR."""
    params = variables["params"]
    sd = flax_to_state_dict(
        params["encoder"], variables["batch_stats"]["encoder"], prefix="encoder."
    )
    sd.update(flax_to_state_dict(params["regressor"], prefix="regressor."))
    return sd


def mean_theta(value) -> torch.Tensor:
    """The trainable mean theta as a (1, 85) f32 tensor."""
    return _t(value).reshape(1, -1)
