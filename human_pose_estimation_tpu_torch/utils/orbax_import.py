"""Read a checkpoint that the JAX package wrote (Orbax) without JAX.

Orbax's ``StandardSave`` writes ``<dir>/<step>/default/`` as an OCDBT key
value store in which every leaf of the saved tree is a zarr (v2) array,
keyed by its tree path joined with ``.`` (``gen_params.encoder.conv1.
kernel``, ``gen_opt.0.count``). ``<step>/default/_METADATA`` holds the
tree's structure (``tree_metadata``: each leaf's path as ``key_metadata``,
``key_type`` 2 for a dict key and 1 for a sequence index, and its
``value_type``, ``"None"`` for an empty node such as optax's
``EmptyState``). tensorstore reads both; importing ``orbax.checkpoint``
would import JAX, so it is not used. tensorstore is imported when a leaf
is read: the card's machine has none, and this importer runs where the JAX
checkpoints are, on the host.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

__all__ = ["is_orbax_step", "read_orbax_tree", "train_state_from_orbax"]

_DICT_KEY = 2
_SEQUENCE_INDEX = 1


def _metadata_path(step_dir: str) -> str:
    return os.path.join(step_dir, "default", "_METADATA")


def is_orbax_step(step_dir: str) -> bool:
    """Whether ``step_dir`` (``<dir>/<step>``) holds an Orbax checkpoint."""
    return os.path.isfile(_metadata_path(step_dir))


def _read_leaf(base: str, path: str) -> np.ndarray:
    import tensorstore as ts

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{base}", "path": f"{path}/"}}
    return np.asarray(ts.open(spec, open=True).result().read().result())


def _to_sequences(node):
    """Turn the dicts whose keys are all sequence indices into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _to_sequences(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node.get(i) for i in range(max(node) + 1)]
    return node


def read_orbax_tree(step_dir: str) -> Any:
    """The tree saved in ``step_dir`` as nested dicts (sequences as lists)
    of numpy arrays, ``None`` where the saved node was empty."""
    step_dir = os.path.abspath(step_dir)
    with open(_metadata_path(step_dir)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{step_dir}: zarr3 checkpoints are not supported (only Orbax's zarr v2 layout)")
    base = os.path.join(step_dir, "default")
    root: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys: List = [
            int(k["key"]) if k["key_type"] == _SEQUENCE_INDEX else k["key"] for k in entry["key_metadata"]
        ]
        value_type = entry["value_metadata"]["value_type"]
        value = None if value_type == "None" else _read_leaf(base, ".".join(str(k) for k in keys))
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _to_sequences(root)


def train_state_from_orbax(step_dir: str) -> Dict:
    """The JAX package's ``TrainState`` saved in ``step_dir`` as the dict
    that ``train.state.TrainState.load_state_dict`` takes: the same dict
    that ``models.port_jax.train_state_from_jax`` gives for that state."""
    from ..models.port_jax import train_state_from_jax

    return train_state_from_jax(read_orbax_tree(step_dir))
