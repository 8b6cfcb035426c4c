"""Checkpoint / resume (counterpart of ``human_pose_estimation_tpu/utils/
checkpoint.py``).

The directory layout is the JAX package's: one ``<dir>/<step>/`` per saved
step, ``input_state.json`` inside it when the input streams have a
position to resume from, and the five newest steps kept. The payload is
one ``torch.save`` of ``TrainState.state_dict()`` (weights, BN statistics,
mean theta, critic, step, both Adam states and the schedules' positions)
as ``<step>/train_state.pt``, with its tensors on the CPU. A step is
written under a temporary name beside the others and renamed into place
when it is whole, so a crash never leaves a half-written latest step.

Every reader also takes a step the JAX package wrote (Orbax:
``<step>/default/_METADATA``), through ``utils/orbax_import.py``; the
layout is told by what is on disk, and a step in neither layout raises.
As with Orbax's checkpoint manager, saving a step at or below the latest
one on disk writes nothing.

Under a process group (``parallel/mesh.py``) every rank calls
``save_train_state``; rank 0 alone writes (the states are replicated), the
others wait at a barrier until the step is on disk, and every rank then
restores from it. ``input_state.json`` holds rank 0's input position, as
the JAX package keeps the one file its processes all write to the same
path; a rank's grain position counts the batches it has read, equal on
every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh as pmesh
from . import orbax_import

__all__ = [
    "PAYLOAD",
    "latest_step",
    "restore_for_inference",
    "restore_input_state",
    "restore_raw",
    "restore_train_state",
    "save_train_state",
]

PAYLOAD = "train_state.pt"
INPUT_STATE = "input_state.json"
MAX_TO_KEEP = 5


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory) if name.isdigit())


def latest_step(directory: str) -> Optional[int]:
    """The newest step saved under ``directory``; None when there is none."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(step))


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _json_np(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"input_state value not JSON-serializable: {type(obj)}")


def save_train_state(
    directory: str,
    state,
    step: Optional[int] = None,
    input_state: Optional[dict] = None,
    max_to_keep: int = MAX_TO_KEEP,
) -> bool:
    """Save ``state`` (a ``TrainState``, or a dict in its ``state_dict``
    layout) at ``step`` (default ``state.step``), with ``input_state`` (a
    JSON-serializable dict, the input streams' positions) beside it. Then
    keep only the ``max_to_keep`` newest steps. Returns whether a step was
    written: a step at or below the latest on disk is not. Under a process
    group rank 0 writes, every rank returns after the step is on disk, with
    rank 0's answer."""
    if pmesh.is_distributed():
        written = _save(directory, state, step, input_state, max_to_keep) if pmesh.rank() == 0 else None
        pmesh.barrier()
        return pmesh.broadcast_object(written)
    return _save(directory, state, step, input_state, max_to_keep)


def _save(directory: str, state, step: Optional[int], input_state: Optional[dict], max_to_keep: int) -> bool:
    is_state = hasattr(state, "state_dict")
    if step is None:
        step = state.step if is_state else state["step"]
    step = int(step)
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    last = latest_step(directory)
    if last is not None and last >= step:
        return False
    payload = state.state_dict() if is_state else dict(state)
    tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=directory)
    try:
        torch.save(_to_device(payload, "cpu"), os.path.join(tmp, PAYLOAD))
        if input_state is not None:
            with open(os.path.join(tmp, INPUT_STATE), "w") as f:
                json.dump(input_state, f, default=_json_np)
        os.rename(tmp, _step_dir(directory, step))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return True


def restore_input_state(directory: str, step: Optional[int] = None) -> Optional[dict]:
    """Input-stream state saved at ``step`` (default latest); None if absent."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    path = os.path.join(_step_dir(directory, step), INPUT_STATE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read(directory: str, step: int, device) -> Dict:
    """The ``state_dict``-layout dict saved at ``step``, in either layout."""
    step_dir = _step_dir(directory, step)
    payload = os.path.join(step_dir, PAYLOAD)
    if os.path.isfile(payload):
        return torch.load(payload, map_location=device, weights_only=True)
    if orbax_import.is_orbax_step(step_dir):
        try:
            sd = orbax_import.train_state_from_orbax(step_dir)
        except (KeyError, TypeError, StopIteration) as e:
            raise ValueError(
                f"checkpoint under {directory!r} (step {step}) has no generator subtree "
                "(is it a TrainState checkpoint?)"
            ) from e
        return _to_device(sd, device)
    raise ValueError(
        f"{step_dir!r} holds a checkpoint in neither layout: no {PAYLOAD} (this package) "
        "and no default/_METADATA (Orbax, the JAX package)"
    )


def restore_train_state(directory: str, template_state) -> Tuple[Any, Optional[int]]:
    """Load the latest checkpoint into ``template_state`` (a
    ``TrainState``, updated in place) and return (state, step); (template,
    None) when there is no checkpoint."""
    step = latest_step(directory)
    if step is None:
        return template_state, None
    template_state.load_state_dict(_read(directory, step, template_state.device))
    return template_state, step


def restore_raw(directory: str, step: Optional[int] = None) -> Tuple[Dict, int]:
    """The checkpoint at ``step`` (default latest) as a ``state_dict``-layout
    dict on the host, without a state to load it into (for grafting weights
    across runs whose optimizers need not match). Raises FileNotFoundError
    when there is no checkpoint."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory!r}")
    return _read(directory, step, "cpu"), step


def restore_for_inference(directory: str, hmr, config) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """What serving needs: the HMR's state dict (on the host) and the
    (1, 85) mean theta.

    Reads nothing of the optimizers, so a checkpoint trained with any
    ``lr_schedule`` serves alike. Without any checkpoint under
    ``directory``, serving starts fresh: ``hmr``'s own weights (its caller
    builds it with ``seed=config.seed``) and the mean theta of
    ``config.mean_params_path``."""
    from .mean_params import load_mean_theta

    step = latest_step(directory)
    if step is None:
        mean = load_mean_theta(config.mean_params_path)
        return hmr.state_dict(), np.asarray(mean, np.float32)
    raw, _ = restore_raw(directory, step)
    try:
        variables, mean_theta = raw["hmr"], raw["mean_theta"]
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"checkpoint under {directory!r} has no generator subtree (is it a TrainState checkpoint?)"
        ) from e
    return variables, np.asarray(mean_theta.detach().cpu(), np.float32).reshape(1, -1)
