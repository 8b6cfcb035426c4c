"""The body model's forward, and its backward to the shape and the pose,
replayed as CUDA graphs.

``core.smpl.smpl_forward`` launches some 135 small kernels for its forward
and some 430 for its backward (the Python loop down the 24-joint tree, and
a ``select`` backward for each joint), one Python call at a time, for
microseconds of device work. A training step calls it once per IEF stage
(once per HMR 2.0 head iteration) and once more, without grad, to pose the
critic's mocap. ``forward(slot, model, beta, theta, joint_type, rotations)``
captures the call once per key (``torch.cuda.CUDAGraph``, in the manner of
``models/encoder_graph.py``) and replays it behind one
``torch.autograd.Function``: the forward graph where the model runs, the
backward graph when autograd reaches the body model. Under no grad mode
only the forward is captured.

``bypass(slot, pose, int8)`` decides from what the call shows, and
``forward`` takes the graphs only where it returns None: under grad mode a
pose that needs a gradient, under no grad mode only the mocap's slot (the
evaluation and serving paths stay eager, which spares a capture per batch
size), never the int8 encoder's path, and a CUDA input. Everything else
runs ``smpl_forward`` eagerly, as before.

A capture is keyed by its slot (``HMR.forward``'s stage index, or
``MOCAP``): all the stages' outputs live through a training step (the
losses, the critic's fakes), and a slot's backward needs the activations
of that slot's own forward. The key holds besides the layout of the shape
and the pose (shape, dtype, strides, storage offset, device), the pose's
form (axis-angle ``theta`` (N, 3K) or matrices ``rotations`` (N, K, 3, 3)),
``joint_type``, grad mode, and the model's layout (``core.smpl.BodyLayout``:
its tree, vertices, shape and expression widths; SMPL's and SMPL-X's
differ) and the storage of its tensors (the expression directions too,
where it has them).

What keeps the replay exact:

* it runs the kernels that eager runs: the body model draws no random
  numbers, holds no state and no parameters, and runs in f32 outside
  autocast; the static inputs take the layout of the caller's, down to the
  storage offset (the IEF's pose and shape are slices of its theta: the
  same row stride and alignment), so the kernels that read them are the
  ones eager picks;
* the model's tensors are read where they lie. A model rebound (``.to()``
  to another device or dtype, a new model) recaptures, and the slot's
  captures on other storage are dropped; a capture keeps its tensors
  alive, so no new tensor takes an address under it;
* the outputs come back as copies of the forward graph's buffers, and the
  gradients of the shape and the pose as copies of the backward graph's.
  An output that no loss reaches brings a gradient of zeros. A backward
  reached after another forward replay of its capture, or reached twice,
  raises: the activations it would read are gone;
* in the matrix form the body model returns its ``rotations`` input: the
  caller's own tensor comes back, so autograd adds the caller's gradient
  of it to the graph's in one more sum, where eager adds every term in one
  sum: the pose's gradient may differ from eager's in the order of that
  sum;
* the captures run on a stream of their own, as the encoder pair's do
  (``models/encoder_graph.py``), never on ``torch.cuda.graph``'s shared
  default one. PyTorch keeps one cuBLAS workspace per (handle, stream),
  so graphs captured on one stream record the same workspace. With the
  encoder pair and the body model both captured on the default stream,
  Multi-HMR's first training step in a process came back with NaN in the
  gradient of the ViT-L/14's last LayerScale (2 seeds of 2, at 896 px and
  batch 8); a stream of its own for either, or no cuBLAS workspace
  (``CUBLAS_WORKSPACE_CONFIG=:0:0``), cleared it.

``CAPTURES`` and ``REPLAYS`` count the captures and the forward replays;
under a profiler each forward replay is the span ``model.smpl.graph``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch.autograd.function import once_differentiable

from ..core.smpl import _TENSOR_FIELDS, SMPLModel, SMPLOutput, smpl_forward
from ..utils.tracing import span

CAPTURES = 0
REPLAYS = 0
WARMUP = 3  # eager passes on a side stream before capture, as make_graphed_callables runs
MOCAP = "mocap"  # the slot of the critic's mocap, posed under no grad

# key -> _Graphs; a key's first entry is its slot, its last the model's storage
_graphs: dict = {}
_capture_streams: dict = {}  # device -> the captures' own stream (the module docstring)


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _capture_streams:
        _capture_streams[dev] = torch.cuda.Stream(dev)
    return _capture_streams[dev]


def bypass(slot: Union[int, str], pose: torch.Tensor, int8: bool = False) -> Optional[str]:
    """Why the body model runs eagerly on ``pose`` in ``slot``, or None
    where its graphs take the call. The rules, in order: the int8
    encoder's path, under grad mode a pose that needs no gradient, under
    no grad mode a slot other than ``MOCAP``, a device other than CUDA."""
    if int8:
        return "the int8 encoder's path"
    if torch.is_grad_enabled():
        if not pose.requires_grad:
            return "a pose that needs no gradient"
    elif slot != MOCAP:
        return "no grad mode"
    if pose.device.type != "cuda":
        return "not on a CUDA device"
    return None


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.stride(), t.storage_offset(), t.device


def _storage(model: SMPLModel) -> tuple:
    tensors = [getattr(model, k) for k in _TENSOR_FIELDS] + ([] if model.exprdirs is None else [model.exprdirs])
    return tuple(t.data_ptr() for t in tensors)


def signature(slot, model: SMPLModel, beta: torch.Tensor, pose: torch.Tensor, joint_type: str,
              matrices: bool) -> tuple:
    """The key of a capture: the slot, the layout of ``beta`` and ``pose``,
    the pose's form (``matrices``: rotations, else axis-angle),
    ``joint_type``, grad mode, and the model's layout and tensors' storage."""
    return (slot, _layout(beta), _layout(pose), matrices, joint_type, torch.is_grad_enabled(), model.layout,
            _storage(model))


def _static(t: torch.Tensor, grad: bool) -> torch.Tensor:
    """A copy of ``t`` with its shape, strides and storage offset, a leaf
    that needs a gradient where ``grad``."""
    extent = 1 + sum((size - 1) * stride for size, stride in zip(t.shape, t.stride()))
    with torch.no_grad():
        base = torch.empty(t.storage_offset() + extent, dtype=t.dtype, device=t.device)
        out = base.as_strided(t.shape, t.stride(), t.storage_offset()).copy_(t)
    return out.requires_grad_(grad)


class _Graphs:
    """One key's forward graph, and under grad mode its backward graph, with
    their static buffers: the shape and the pose in, the outputs the body
    model computes out (verts, joints, joints_smpl, and the rotations in
    the axis-angle form), the gradients of those outputs in and of the
    shape and the pose out."""

    def __init__(self, model: SMPLModel, beta: torch.Tensor, pose: torch.Tensor, joint_type: str, matrices: bool):
        global CAPTURES
        grad = torch.is_grad_enabled()
        self.model = model  # the captured storage, kept alive with the graphs
        self.beta, self.pose = _static(beta, grad), _static(pose, grad)
        inputs = [self.beta, self.pose]

        def run():
            kw = {"theta": None, "rotations": self.pose} if matrices else {"theta": self.pose}
            out = smpl_forward(model, self.beta, joint_type=joint_type, **kw)
            return [out.verts, out.joints, out.joints_smpl] + ([] if matrices else [out.rotations])

        dev = beta.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):  # cuBLAS's workspace and the allocator, outside the capture
                    outs = run()
                    if grad:
                        torch.autograd.grad(outs, inputs, [torch.zeros_like(o) for o in outs])
                    del outs
            torch.cuda.current_stream(dev).wait_stream(side)
            self.fwd = torch.cuda.CUDAGraph()
            pool, stream = torch.cuda.graph_pool_handle(), _capture_stream(dev)
            with torch.cuda.graph(self.fwd, pool=pool, stream=stream):
                outs = run()
            if grad:
                self.grad_outs = [torch.zeros_like(o) for o in outs]
                self.bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.bwd, pool=pool, stream=stream):
                    self.grads = torch.autograd.grad(outs, inputs, self.grad_outs)
            self.outs = [o.detach() for o in outs]
        self.generation = 0  # forward replays and backward replays so far
        CAPTURES += 1


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs: _Graphs, beta: torch.Tensor, pose: torch.Tensor):
        global REPLAYS
        graphs.beta.copy_(beta)
        graphs.pose.copy_(pose)
        graphs.fwd.replay()
        graphs.generation += 1
        ctx.graphs, ctx.generation = graphs, graphs.generation
        ctx.set_materialize_grads(False)
        REPLAYS += 1
        return tuple(o.clone() for o in graphs.outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graphs = ctx.graphs
        if graphs.generation != ctx.generation:
            raise RuntimeError(
                "the graphed body model's backward needs the activations of its own forward, and another "
                "forward or backward of the same capture has run since"
            )
        graphs.generation += 1
        for buf, g in zip(graphs.grad_outs, grads):
            if g is None:
                buf.zero_()
            else:
                buf.copy_(g)
        graphs.bwd.replay()
        return (None, *(g.clone() for g in graphs.grads))


def forward(slot: Union[int, str], model: SMPLModel, beta: torch.Tensor, theta: Optional[torch.Tensor],
            joint_type: str = "cocoplus", rotations: Optional[torch.Tensor] = None, int8: bool = False) -> SMPLOutput:
    """``smpl_forward(model, beta, theta, joint_type, rotations)`` by the
    graphs of ``slot``, captured on the key's first call, where ``bypass``
    returns None (``int8``: the call is on the int8 encoder's path), and
    eagerly otherwise; the same outputs either way."""
    pose = theta if rotations is None else rotations
    if (theta is None) == (rotations is None) or bypass(slot, pose, int8) is not None:
        return smpl_forward(model, beta, theta, joint_type, rotations)  # which refuses a pose given twice
    matrices = rotations is not None
    key = signature(slot, model, beta, pose, joint_type, matrices)
    graphs = _graphs.get(key)
    if graphs is None:
        for old in [k for k in _graphs if k[0] == slot and k[-1] != key[-1]]:
            del _graphs[old]  # captured on storage the model no longer holds
        graphs = _graphs[key] = _Graphs(model, beta, pose, joint_type, matrices)
    with span("model.smpl.graph"):
        outs = _Replay.apply(graphs, beta, pose)
    return SMPLOutput(verts=outs[0], joints=outs[1], rotations=rotations if matrices else outs[3],
                      joints_smpl=outs[2])
