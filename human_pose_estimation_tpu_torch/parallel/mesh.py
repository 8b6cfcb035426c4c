"""Data parallelism across processes (counterpart of
``human_pose_estimation_tpu/parallel/mesh.py``).

The JAX package lays the batch over a 1-D ``data`` mesh and XLA inserts
the reductions: a step over a sharded batch computes every batch statistic
over the GLOBAL batch. Here each process (a rank) holds B rows of the
global batch of R x B rows, the parameters are replicated, and the step
reduces what is global itself. No ``DistributedDataParallel``: its reducer
hooks would fire inside the critic's double backward
(``torch.autograd.grad(..., create_graph=True)``). Instead:

* a batch statistic inside the forward (BatchNorm's moments, the reference
  penalty's mean gradient) goes through ``global_sum``, a differentiable
  all-reduce whose backward sums the ranks' cotangents;
* a batch mean is this rank's share of the global mean
  (``mean_share``: its rows' mean over the world size);
* random numbers for the batch are drawn for all R x B rows from the
  step's generator, and each rank keeps its own rows (``draw_rows``), as
  ``jax.random`` over a sharded array does;
* each optimizer's gradients go through one flat all-reduce
  (``all_reduce_grads``) before its update.

Every rank holds the same number of rows, so a global mean is the mean
of the ranks' means: a world of 1 computes the one-process step's bits.
With no process group initialized every helper is the identity (rank 0 of
a world of 1), and a single process computes what it computed before,
bit for bit.

Launch with torchrun, which sets the environment
``maybe_initialize_distributed`` reads::

    torchrun --nproc_per_node=N -m human_pose_estimation_tpu_torch.cli.train ...
"""
from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = [
    "all_gather_rows",
    "all_reduce_grads",
    "barrier",
    "broadcast_object",
    "draw_rows",
    "global_sum",
    "global_sums",
    "is_distributed",
    "local_rows",
    "make_mesh",
    "maybe_initialize_distributed",
    "mean_share",
    "pad_to_multiple",
    "rank",
    "replicate",
    "row_index",
    "world_size",
]


def is_distributed() -> bool:
    """Whether a process group is up (a world of 1 counts: its step takes
    the data-parallel path)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def make_mesh(devices: Optional[Sequence] = None, batch_size: Optional[int] = None) -> List[torch.device]:
    """The local devices of a data-parallel replica set: ``devices``, or
    every CUDA device of this process (raises without one). With
    ``batch_size`` the list is trimmed to the largest count that divides
    it, as the JAX ``make_mesh`` does (a batch of 4 on 8 devices uses 4)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if batch_size is not None:
        devices = devices[: math.gcd(batch_size, len(devices))]
    return devices


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def maybe_initialize_distributed(device=None) -> bool:
    """Initialize the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``): NCCL
    on ``cuda`` (with this process's card ``LOCAL_RANK`` made current),
    gloo on ``cpu``. A group the caller already initialized is left as it
    is; without that environment nothing happens. A backend that cannot
    start raises: there is no fallback to another. Returns whether more
    than one process runs."""
    if not is_distributed() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
        )
    return world_size() > 1


def _group_device(device: torch.device) -> torch.device:
    """Where a collective's buffer must live: the current card under NCCL,
    else the tensor's own device (gloo takes CPU and CUDA tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def barrier() -> None:
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable objects: a config, a flag)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks. Differentiable when ``t`` requires
    a gradient: the backward is the all-reduce of the cotangents, so each
    rank's backward carries every rank's loss back through its own rows."""
    if not is_distributed():
        return t
    if t.requires_grad:
        # deprecated in favour of the functional collectives, which have no
        # differentiable all_reduce (their autograd variants gather and scatter)
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t)
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def mean_share(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch (over
    every element, or over ``dim``): its own mean over the world size (the
    ranks hold equal counts), so that the ranks' shares add up to the
    global mean. One process: ``x.mean(dim)``; a world of 1 computes the
    same bits."""
    m = x.mean() if dim is None else x.mean(dim=dim)
    return m / world_size() if is_distributed() else m


def _rows_of(full: torch.Tensor, blocks: int, r: int, w: int) -> torch.Tensor:
    """Rank ``r``'s rows of a global tensor made of ``blocks`` equal blocks
    over ``w`` ranks, by a view (no index tensor to copy to the card)."""
    rest = full.shape[1:]
    return full.reshape(blocks, w, full.shape[0] // (blocks * w), *rest)[:, r].reshape(-1, *rest)


def row_index(n_local: int, blocks: int = 1, rank_: Optional[int] = None, world: Optional[int] = None):
    """The global rows a rank holds, for a tensor of ``n_local`` rows made
    of ``blocks`` equal blocks (the critic's fakes are the IEF stages'
    rows concatenated, stage by stage): block k of rank r is rows
    ``(k * world + r) * b + j`` of the global tensor, ``b = n_local //
    blocks``. Defaults: this process's rank and world."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    if n_local % blocks:
        raise ValueError(f"{n_local} rows do not split into {blocks} blocks")
    return _rows_of(torch.arange(n_local * w), blocks, r, w)


def local_rows(full: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch (``row_index``'s
    layout). One process: ``full`` itself."""
    if not is_distributed():
        return full
    return _rows_of(full, blocks, rank(), world_size())


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int], blocks: int = 1) -> torch.Tensor:
    """``draw(shape)`` as the one-process run over the global batch draws
    it: ``draw`` is called with the global shape (R x the rows of
    ``shape``) and this rank keeps its rows, so every rank advances the
    step's generator alike. One process: ``draw(shape)``."""
    shape = tuple(shape)
    if not is_distributed():
        return draw(shape)
    return local_rows(draw((shape[0] * world_size(), *shape[1:])), blocks)


def _flat_collective(tensors: Sequence[torch.Tensor], op: Callable[[torch.Tensor], None]) -> List[torch.Tensor]:
    """Run ``op`` in place on one flat buffer per dtype of ``tensors``; the
    results, in order, as views of those buffers (on each tensor's device)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        dev = _group_device(tensors[idx[0]].device)
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev) for i in idx])
        op(flat)
        at = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[at : at + t.numel()].view(t.shape).to(t.device)
            at += t.numel()
    return out


def global_sums(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the ranks of several tensors (detached), in one flat
    all-reduce per dtype. One process: the tensors as they are."""
    if not is_distributed():
        return list(tensors)
    return _flat_collective(tensors, dist.all_reduce)


def all_reduce_grads(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]]):
    """An optimizer's gradients summed over the ranks in one flat
    all-reduce (one per dtype; the states hold one): a missing gradient
    counts as zeros. One process: ``grads`` as they are.

    Summing is exact for the training step's losses: each rank's loss is
    its SHARE of the global-batch loss (batch means over the world size,
    ``mean_share``; a term every rank computes whole, the reference
    penalty, divided by the world size), so the shares add up to the
    global loss; and every batch statistic inside the forward is a
    differentiable ``global_sum``, whose backward hands each rank the
    derivative of all ranks' losses through its own rows. The sum over the
    ranks of those per-rank gradients is the gradient of the global loss."""
    if not is_distributed():
        return grads
    return global_sums([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


def replicate(state) -> None:
    """Broadcast rank 0's training state into every rank's, in place: the
    HMR's and the critic's parameters and buffers, the mean theta and both
    optimizers' state (one flat broadcast per dtype). One process: nothing."""
    if not is_distributed():
        return
    tensors = list(state.hmr.state_dict().values()) + list(state.critic.state_dict().values())
    tensors.append(state.mean_theta.data)
    for opt in (state.gen_opt, state.critic_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [v for v in opt.state.get(p, {}).values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t, v in zip(tensors, _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0))):
            t.copy_(v)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (their counts may differ), concatenated
    in rank order, on every rank: an all-reduce of a zero-filled buffer in
    which each rank fills its own slot (gloo has no all-gather of CUDA
    tensors; adding zeros is exact). One process: ``t``."""
    if not is_distributed():
        return t
    dev = _group_device(t.device)
    counts = torch.zeros(world_size(), dtype=torch.int64, device=dev)
    counts[rank()] = t.shape[0]
    dist.all_reduce(counts)
    counts = counts.tolist()
    buf = torch.zeros((world_size(), max(counts), *t.shape[1:]), dtype=t.dtype, device=dev)
    buf[rank(), : t.shape[0]] = t.to(dev)
    dist.all_reduce(buf)
    return torch.cat([buf[i, :c] for i, c in enumerate(counts)]).to(t.device)
