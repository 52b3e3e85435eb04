"""ZDP weights gathered on use: what XLA's SPMD partitioner does for the
JAX package, by hand over a `launch.mesh.DataMesh`.

A ZDP leaf lives on each rank as its shard, 1/W of the leaf along its
ZDP dimension.  `Gathered(shard, mesh, dim)` stands for the full weight
of one use site (a layer's slice of a leaf, or the embedding over a
whole step):

  * `handle` is a tensor of the full shape that holds no memory (one
    element, expanded), tied to the shard by `_Handle`, whose backward
    reduce-scatters the full weight's gradient onto the shard;
  * `views` are the pieces a consumer takes, cut from the handle by the
    same view ops that cut the gathered weight (`split`): the whole
    weight, or `chunked_ffn`'s chunks.  Their gradients flow back
    through those views to the handle, assembled as autograd assembles
    them for an unsharded weight;
  * a consumer (`kernels.ops.matmul`, `ops.matmul_acc`, `lookup`) takes
    a view as its weight for autograd and a `Piece` for the data: its
    forward gathers the weight, uses it and drops it, and saves only
    the view; its backward gathers again.

So autograd holds the shard, never the gathered weight, and a use costs
two all-gathers and one reduce-scatter, plus one all-gather when its
layer is recomputed (a recompute builds its own `Gathered`): the cost
model's k of 3, +1 under remat.

Uses that share one gather: inside `hold()` every piece comes from one
gathered copy (the chunks of `chunked_ffn`; the embedding's lookup and
tied head over a whole forward).  After `end_forward()`, the first
fetch gathers once more and the copy stays until the last consumer that
fetched in the forward has run its backward: one backward gather for
all of a step's uses, recomputed ones (the checkpointed cross-entropy
chunks) included.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch


def _whole(w: torch.Tensor) -> List[torch.Tensor]:
    return [w]


class _Handle(torch.autograd.Function):
    """shard -> a stand-in of the full weight that holds no memory; the
    backward reduce-scatters the full gradient onto the shard."""

    @staticmethod
    def forward(ctx, shard, mesh, dim, key, shape):
        ctx.mesh, ctx.dim, ctx.key = mesh, dim, key
        return shard.new_zeros(()).expand(shape)

    @staticmethod
    def backward(ctx, dfull):
        return (ctx.mesh.reduce_scatter(dfull.contiguous(), ctx.dim,
                                        ctx.key), None, None, None, None)


class Gathered:
    """The full weight of one use site of a ZDP shard (see the module
    note).  `split` maps a full weight (the gathered one, or the handle)
    to the pieces its consumers take, by view ops and copies only."""

    def __init__(self, shard: torch.Tensor, mesh, dim: int, key: str = "",
                 split: Optional[Callable] = None):
        self.shard, self.mesh, self.dim, self.key = shard, mesh, dim, key
        shape = list(shard.shape)
        shape[dim] *= mesh.world
        self.shape = tuple(shape)
        self._split = split or _whole
        self.handle = _Handle.apply(shard, mesh, dim, key, self.shape)
        self.views = self._split(self.handle)
        self._pieces: Optional[List[torch.Tensor]] = None
        self._forward = True
        self._uses = 0       # forward fetches whose backward fetches again

    def _gather(self) -> List[torch.Tensor]:
        return self._split(self.mesh.gather(self.shard.detach(), self.dim,
                                            self.key))

    def _acquire(self) -> List[torch.Tensor]:
        if self._pieces is None:
            self._pieces = self._gather()
        return self._pieces

    @contextlib.contextmanager
    def hold(self):
        """One gathered copy for every forward use inside."""
        self._acquire()
        try:
            yield self
        finally:
            self._pieces = None

    def end_forward(self) -> None:
        """The forward is done: later fetches are the backward's."""
        self._forward = False
        self._pieces = None

    def piece(self, j: int = 0) -> "Piece":
        return Piece(self, j)


class Piece:
    """The data of `Gathered.views[j]`, fetched by a consumer."""

    def __init__(self, g: Gathered, j: int):
        self.g, self.j = g, j

    def forward(self, again_in_backward: bool = True) -> torch.Tensor:
        """The piece for a forward use.  In the forward pass it is the
        held copy or a gather of its own (`again_in_backward`: the
        consumer's backward will fetch it); in the backward (a
        recompute) the backward's copy."""
        g = self.g
        if not g._forward:
            return g._acquire()[self.j]
        if again_in_backward:
            g._uses += 1
        return (g._pieces or g._gather())[self.j]

    def backward(self) -> torch.Tensor:
        """The piece for a consumer's backward: gathered by the first
        one, kept until `release` by the last."""
        return self.g._acquire()[self.j]

    def release(self) -> None:
        g = self.g
        g._uses -= 1
        if g._uses <= 0:
            g._pieces = None


class _Lookup(torch.autograd.Function):
    """E[tokens] of a gathered embedding; the backward is autograd's for
    indexing (zeros, then an accumulating `index_put_`) and needs no
    weight."""

    @staticmethod
    def forward(ctx, tokens, view, piece):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = view.shape, view.dtype
        return piece.forward(again_in_backward=False)[tokens]

    @staticmethod
    def backward(ctx, dout):
        (tokens,) = ctx.saved_tensors
        dw = torch.zeros(ctx.shape, dtype=ctx.dtype, device=dout.device)
        return None, dw.index_put_((tokens,), dout, accumulate=True), None


def lookup(w, tokens: torch.Tensor) -> torch.Tensor:
    """Rows `tokens` of the embedding `w`: a tensor, or a `Gathered`."""
    if isinstance(w, Gathered):
        return _Lookup.apply(tokens.long(), w.views[0], w.piece(0))
    return w[tokens.long()]
