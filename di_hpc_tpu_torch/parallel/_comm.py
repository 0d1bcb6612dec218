"""The parallel package's collectives: every one of them goes through here.

Operations over one axis of a Mesh, each a `torch.autograd.Function`
under the package's contract (every rank holds the same global tensors and
gets the same global result).  A tensor is either replicated (every rank
holds it and computes the same function of it) or a rank's own part of the
work (each rank computes something else with it); the backwards follow:

 - `all_gather(x, mesh, axis, dim)`: the ranks' equal pieces concatenated
   along `dim` in rank order.  By default every rank computes the same
   function of the whole (a replicated result), so the gradient of rank
   k's piece is slice k of this rank's gradient.  With `each_own=True` each
   rank uses the whole for its own part of the work (a chunk's carry, a
   neighbour's boundary row), and the gradient of rank k's piece is the
   sum over the ranks of their gradients of slice k (a reduce-scatter, as
   a gather and a sum in rank order), as JAX transposes its all_gather;
 - `shard(x, mesh, axis, dim)`: this rank's piece of a global tensor (a
   copy).  Its backward gathers every rank's piece of the gradient, so the
   global tensor gets its whole gradient on every rank;
 - `window(x, mesh, axis, size, extra)`: rows [k*size, (k+1)*size + extra)
   of a global tensor on rank k, which overlap their neighbours' by
   `extra` rows.  Its backward sums every rank's rows into the global
   gradient in rank order;
 - `reduce(x, mesh, axis, op)`: the sum or mean of every rank's tensor,
   as an all-gather and then a sum in rank order, so every rank gets
   bitwise the same value and a repeated run gets the same bits (no
   all-reduce, whose summation order is the backend's).  Its backward hands
   each rank its share of the gradient (all of it for a sum, 1/K for a
   mean);
 - `fan_out(x, mesh, axis)`: a replicated tensor that each rank uses for
   its own part of the work (the activations entering a layer whose
   output columns are split over the axis).  The identity forward; its
   backward sums every rank's gradient in rank order, as JAX transposes
   the replication into a psum.

On an axis of size 1 each is the identity (a world of one has no process
group).  Under gloo a CUDA operand is copied to the host, gathered there
and copied back, inside `_gather_pieces` only; the compute stays on the
card.  Under NCCL the operands stay on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "shard", "window", "reduce", "fan_out",
           "axis_split"]


def axis_split(n: int, mesh, axis: str, what: str):
    """(start, size) of this rank's piece of n items split over `axis`;
    ValueError when the axis does not divide n."""
    k = mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"{what}: {n} does not tile the {axis!r} axis of "
                         f"size {k}")
    size = n // k
    return mesh.axis_index(axis) * size, size


def _gather_pieces(x: torch.Tensor, mesh, axis: str) -> list:
    """Every rank's `x` along `axis`, in rank order (equal shapes)."""
    if mesh.axis_size(axis) == 1:
        return [x]
    group = mesh.group(axis)
    piece = x.detach().contiguous()
    staged = piece.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        piece = piece.cpu()
    out = [torch.empty_like(piece) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(out, piece, group=group)
    if staged:
        out = [o.to(x.device) for o in out]
    return out


def _rank_order_sum(pieces: list) -> torch.Tensor:
    total = pieces[0]
    for p in pieces[1:]:
        total = total + p
    return total


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, each_own):
        ctx.meta = (mesh, axis, dim, x.shape[dim], each_own)
        return torch.cat(_gather_pieces(x, mesh, axis), dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, n, each_own = ctx.meta
        if each_own:
            grad = _rank_order_sum(_gather_pieces(grad, mesh, axis))
        return (grad.narrow(dim, mesh.axis_index(axis) * n, n), None, None,
                None, None)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        start, size = axis_split(x.shape[dim], mesh, axis,
                                 f"dim {dim} of a {tuple(x.shape)} tensor")
        ctx.meta = (mesh, axis, dim)
        return x.narrow(dim, start, size).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim = ctx.meta
        return torch.cat(_gather_pieces(grad, mesh, axis), dim), None, None, \
            None


class _Window(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, size, extra):
        ctx.meta = (mesh, axis, size, extra, x.shape)
        start = mesh.axis_index(axis) * size
        return x[start:start + size + extra].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, size, extra, shape = ctx.meta
        # Every rank's rows, padded to size + extra (the last rank's stop
        # at the tensor's end), added into the global gradient in rank order.
        pad = size + extra - grad.shape[0]
        piece = torch.cat([grad, grad.new_zeros((pad,) + grad.shape[1:])])
        out = grad.new_zeros(shape)
        for k, p in enumerate(_gather_pieces(piece, mesh, axis)):
            rows = min(size + extra, shape[0] - k * size)
            out[k * size:k * size + rows] += p[:rows]
        return out, None, None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        pieces = _gather_pieces(x, mesh, axis)
        ctx.scale = 1.0 / len(pieces) if mean else 1.0
        total = _rank_order_sum(pieces)
        return total / len(pieces) if mean else total.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis = ctx.meta
        return _rank_order_sum(_gather_pieces(grad, mesh, axis)), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
               each_own: bool = False) -> torch.Tensor:
    return _AllGather.apply(x, mesh, axis, dim, each_own)


def shard(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _Shard.apply(x, mesh, axis, dim)


def window(x: torch.Tensor, mesh, axis: str, size: int, extra: int
           ) -> torch.Tensor:
    return _Window.apply(x, mesh, axis, size, extra)


def reduce(x: torch.Tensor, mesh, axis: str, op: str = "mean"
           ) -> torch.Tensor:
    if op not in ("mean", "sum"):
        raise ValueError(f"reduce: op must be 'mean' or 'sum', got {op!r}")
    return _Reduce.apply(x, mesh, axis, op == "mean")


def fan_out(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _FanOut.apply(x, mesh, axis)
