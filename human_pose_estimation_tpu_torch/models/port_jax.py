"""Weight bridge: the JAX package's variables -> this package's state.

Takes the Flax trees as nested dicts of NUMPY arrays (the caller converts,
e.g. with ``jax.tree.map(np.asarray, variables)``), so this module imports
no JAX. Layout changes:

* Conv kernel HWIO -> ``Conv2d.weight`` OIHW;
* Dense kernel (in, out) -> ``Linear.weight`` (out, in);
* BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (plus a zero ``num_batches_tracked``);
* a training state (``train_state_from_jax``): the weights as above, the
  step, and each optax Adam state's ``mu`` / ``nu`` / ``count`` as the
  torch Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step``, with the weights'
  transposes. The state may be the JAX ``TrainState`` itself or the plain
  nested containers of a checkpoint read without a template
  (``utils/orbax_import.py``), where the optax chain is an index-keyed
  list of dicts instead of ``ScaleByAdamState`` objects.

Module names match the Flax names one to one (models/resnet.py), so the
walk is generic.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "hmr_state_dict", "mean_theta", "train_state_from_jax"]


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
            if name in stats:  # absent from parameter-shaped trees (Adam moments)
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


def _gen_tree_to_torch(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A parameter-shaped generator tree {'encoder', 'regressor',
    'mean_theta'} -> torch names (``train.state.gen_named_params``)."""
    out = flax_to_state_dict(tree["encoder"], prefix="encoder.")
    out.update(flax_to_state_dict(tree["regressor"], prefix="regressor."))
    out["mean_theta"] = mean_theta(tree["mean_theta"])
    return out


def _get(node, name: str):
    """A field of a state object, or the same key of its plain-dict form."""
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _has(node, name: str) -> bool:
    return name in node if isinstance(node, Mapping) else hasattr(node, name)


def _adam(opt_state, to_torch) -> Dict:
    """The Adam moments inside an optax ``adam`` chain state: a tuple of
    states (``ScaleByAdamState`` among them) or its plain form, a list or
    an index-keyed dict of dicts (``None`` for an ``EmptyState``)."""
    parts = opt_state.values() if isinstance(opt_state, Mapping) else opt_state
    adam = next(s for s in parts if s is not None and _has(s, "mu") and _has(s, "nu"))
    return {
        "step": int(np.asarray(_get(adam, "count"))),
        "exp_avg": to_torch(_get(adam, "mu")),
        "exp_avg_sq": to_torch(_get(adam, "nu")),
    }


def train_state_from_jax(state) -> Dict:
    """The JAX package's ``TrainState`` as numpy (``jax.tree.map(np.asarray,
    state)``) -> the dict that ``train.state.TrainState.load_state_dict``
    takes: ``step``, ``hmr`` (state dict), ``mean_theta``, ``critic``
    (state dict), and ``gen_adam`` / ``critic_adam`` ({'step', 'exp_avg',
    'exp_avg_sq'}, the moments keyed by torch parameter name). ``state``
    may also be the plain nested dict of its fields (a checkpoint read
    without a template)."""
    gen = _get(state, "gen_params")
    variables = {
        "params": {k: gen[k] for k in ("encoder", "regressor")},
        "batch_stats": _get(state, "batch_stats"),
    }
    return {
        "step": int(np.asarray(_get(state, "step"))),
        "hmr": hmr_state_dict(variables),
        "mean_theta": mean_theta(gen["mean_theta"]),
        "critic": flax_to_state_dict(_get(state, "critic_params")),
        "gen_adam": _adam(_get(state, "gen_opt"), _gen_tree_to_torch),
        "critic_adam": _adam(_get(state, "critic_opt"), flax_to_state_dict),
    }
