"""The train-mode encoder's forward and backward replayed as one CUDA graph
pair.

A training step's ResNet-50 launches some 3400 kernels for its forward and
its parameters' backward, one Python call at a time, for a few ms of device
work, and ViT-H some 3600 for ~100 ms: the host sets the step's pace, or
paces the encoder while the rest of the step waits behind it.
``encode(hmr, images, masks)`` captures the two passes once per input
signature (``torch.cuda.CUDAGraph``, in the manner of
``torch.cuda.make_graphed_callables``) and replays them behind one
``torch.autograd.Function``: the forward graph where the model runs, the
backward graph when autograd reaches the features.

``bypass(hmr, images)`` decides from what the call shows, and the model
takes the graph pair only where it returns None (the int8 encoder, an
inference path, branches off before): the encoder in train mode under
grad mode, every encoder parameter and not the images needing a
gradient, no rematerialisation (its recompute belongs to the eager
backward), no process group (the BatchNorm moments' all-reduce, and
``draw_rows``'s rows, cannot sit in a graph) and a CUDA input. Everything
else runs the encoder eagerly, as before.

Every encoder draws its random numbers before its forward
(``draw_masks``, called by ``HMR.forward``), so none are drawn in a
replay: ``encode`` copies the step's masks (the ViT's stochastic depth)
into the capture's static mask buffer beside the static images. Capture's
warm-up passes and the capture itself run on a throwaway mask of ones.
Masks of None (the ResNet's) have no buffer.

What keeps the replay exact:

* it runs the kernels that eager runs: bf16 autocast (without autocast's
  weight-cast cache, which capture forbids: a forward casts each weight
  once either way), ``FlaxBatchNorm2d``'s f32 moments with the clamped fast
  variance, and its in-place running-statistics update, once a forward
  replay;
* capture's warm-up passes are real train-mode forwards: the encoder's
  buffers are saved before and copied back after, so the first call moves
  them once, as eager does;
* a capture is keyed by the images' shape, dtype, strides and device, the
  encoder's autocast dtype and the storage of every encoder parameter and
  buffer. A tensor rebound (``.to()``, ``load_state_dict(assign=True)``)
  recaptures, and the captures of the old storage are dropped; a capture
  keeps its tensors alive, so no new tensor takes an address under it.
  In-place loads (``load_state_dict``, a checkpoint restore) keep the
  storage and the capture;
* the features come back as a copy of the forward graph's buffer; the
  parameters' gradients are the backward graph's own buffers, as the
  training step hands them to Adam before the next replay refills them. A
  caller that keeps them across a replay keeps a copy: ``.backward()``
  does (autograd copies a gradient that another reference holds into
  ``.grad``). A backward reached after another forward replay of its
  capture, or reached twice, raises: the activations it would read are
  gone.

``CAPTURES`` and ``REPLAYS`` count the captures and the forward replays;
under a profiler each forward replay is the span ``model.encoder.graph``.
"""
from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..parallel import mesh as pmesh
from ..utils.tracing import span

CAPTURES = 0
REPLAYS = 0
WARMUP = 3  # eager forward-backward passes on a side stream before capture, as make_graphed_callables runs

# encoder module -> {signature: _Pair}; an entry goes with its encoder
_pairs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _tensors(encoder):
    """(parameters, buffers) of ``encoder`` in ``parameters()`` and
    ``buffers()`` order, read off its modules in one walk."""
    modules = list(encoder.modules())
    return ([p for m in modules for p in m._parameters.values() if p is not None],
            [b for m in modules for b in m._buffers.values() if b is not None])


def bypass(hmr, images: torch.Tensor) -> Optional[str]:
    """Why ``hmr``'s encoder runs eagerly on ``images``, or None where the
    graph pair takes the call. The rules, in order: eval mode, no grad
    mode, ``remat_encoder``, a process group, gradients other than every
    encoder parameter's, a device other than CUDA."""
    encoder = hmr.encoder
    if not encoder.training:
        return "eval mode"
    if not torch.is_grad_enabled():
        return "no grad mode"
    if hmr.remat_encoder:
        return "remat_encoder"
    if pmesh.is_distributed():
        return "process group"
    if images.requires_grad or not all(p.requires_grad for p in _tensors(encoder)[0]):
        return "gradients other than the parameters'"
    if images.device.type != "cuda":
        return "not on a CUDA device"
    return None


def signature(hmr, images: torch.Tensor, params=None, buffers=None) -> tuple:
    """The key of ``images``' capture: their shape, dtype, strides and
    device, the autocast dtype, and the storage of the encoder's parameters
    and buffers, in order (``params`` and ``buffers``: the encoder's, where
    the caller has them)."""
    if params is None:
        params, buffers = _tensors(hmr.encoder)
    return (tuple(images.shape), images.dtype, images.stride(), images.device, hmr.encoder_dtype,
            tuple(t.data_ptr() for t in params) + tuple(t.data_ptr() for t in buffers))


class _Pair:
    """One signature's forward and backward graphs and their static buffers:
    the images, and the masks where the encoder takes them (``masks``, the
    step's, gives their shape; the capture runs on ones)."""

    def __init__(self, hmr, images: torch.Tensor, params, buffers, masks: Optional[torch.Tensor] = None):
        global CAPTURES
        encoder = hmr.encoder
        enabled = hmr.encoder_dtype == torch.bfloat16
        # the captured storage, kept alive with the graphs
        self.params, self.buffers = params, buffers
        self.masks = None if masks is None else torch.ones_like(masks)

        def run(x):
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=enabled, cache_enabled=False):
                return encoder(x, self.masks)

        dev = images.device
        saved = [b.detach().clone() for b in self.buffers]
        self.images = images.detach().clone()
        with torch.cuda.device(dev), torch.enable_grad():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):  # cuDNN's plans and the allocator, outside the capture
                    out = run(self.images)
                    torch.autograd.grad(out, self.params, torch.zeros_like(out))
                    del out
            torch.cuda.current_stream(dev).wait_stream(side)
            self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.graph(self.fwd, pool=pool):
                out = run(self.images)
            self.grad_out = torch.zeros_like(out)
            with torch.cuda.graph(self.bwd, pool=pool):
                self.grads = list(torch.autograd.grad(out, self.params, self.grad_out))
            self.out = out.detach()
            with torch.no_grad():
                for b, s in zip(self.buffers, saved):
                    b.copy_(s)
        self.generation = 0  # forward replays and backward replays so far
        CAPTURES += 1


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair: _Pair, images: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        global REPLAYS
        pair.images.copy_(images)
        pair.fwd.replay()
        pair.generation += 1
        ctx.pair, ctx.generation = pair, pair.generation
        REPLAYS += 1
        return pair.out.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        pair = ctx.pair
        if pair.generation != ctx.generation:
            raise RuntimeError(
                "the graphed encoder's backward needs the activations of its own forward, and another "
                "forward or backward of the same capture has run since"
            )
        pair.generation += 1
        pair.grad_out.copy_(grad)
        pair.bwd.replay()
        return (None, None, *pair.grads)


def encode(hmr, images: torch.Tensor, masks: Optional[torch.Tensor]) -> torch.Tensor:
    """``hmr``'s train-mode encoder on ``images`` ((N, H, W, 3) on a CUDA
    device) and the step's ``masks`` (``hmr.encoder.draw_masks``'s) by its
    graph pair, captured on the signature's first call: its f32 features
    ((N, feature_dim) from the ResNet, (N, tokens, width) from the ViT),
    differentiable in the encoder's parameters. Call only where ``bypass``
    returns None."""
    encoder = hmr.encoder
    params, buffers = _tensors(encoder)
    key = signature(hmr, images, params, buffers)
    pairs = _pairs.setdefault(encoder, {})
    pair = pairs.get(key)
    if pair is None:
        for old in [k for k in pairs if k[-1] != key[-1]]:
            del pairs[old]  # captured on storage the encoder no longer holds
        pair = pairs[key] = _Pair(hmr, images, params, buffers, masks)
    with span("model.encoder.graph"):
        if masks is not None:
            pair.masks.copy_(masks)
        # the module's own parameters, which may be new objects on the
        # captured storage: autograd hands their gradients to them
        return _Replay.apply(pair, images, *params)
