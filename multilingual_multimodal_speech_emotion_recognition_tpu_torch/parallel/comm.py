"""Collectives with gradients, for functions whose inputs and outputs are
the same on every rank (the sequence-parallel and pipelined encoder
stacks).

Such a function takes replicated inputs, splits the work over the ranks and
returns a replicated output. Every rank then computes the same loss from
it, so every rank holds the same cotangent of the output. The gradient each
rank's backward finds for an input is only its own share of the work's, so
`replicated_in` sums them over the ranks; `gather_dim` and `broadcast`
hand back each rank's part of the cotangent once, not summed. `send` and
`recv` carry a pipeline's activations one hop forward and their gradients
the hop back. Under no_grad each is its forward collective alone.

The backward collectives run in autograd's order, which must be the same on
every rank for the ranks to meet: a pipeline stage issues its hops in
microbatch order and autograd runs them back in reverse on every stage.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        for group in ctx.groups:
            dist.all_reduce(flat, group=group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at: at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        return (None, *out)


def replicated_in(groups: Sequence, *xs: Tensor) -> List[Tensor]:
    """xs unchanged; in the backward, their gradients summed over every
    group of `groups` (one all-reduce of all of them a group). Every rank
    must use every output on its loss's path, or its backward never
    reaches this and the others wait for it."""
    return list(_ReplicatedIn.apply(tuple(groups), *xs))


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank], None, None


def gather_dim(x: Tensor, dim: int, group) -> Tensor:
    """The ranks' equal-sized blocks of x concatenated along `dim` in group
    rank order; the backward keeps this rank's block of the cotangent."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherDim.apply(x, dim, group)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.owner = dist.get_rank() == src
        x = x.detach().clone().contiguous()
        dist.broadcast(x, src, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else torch.zeros_like(g)), None, None


def broadcast(x: Tensor, src: int, group) -> Tensor:
    """The global rank `src`'s x on every rank of the group; the backward
    hands the cotangent to `src` alone."""
    return _Broadcast.apply(x, src, group)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peer):
        ctx.peer, ctx.shape, ctx.dtype = peer, x.shape, x.dtype
        dist.send(x.contiguous(), peer)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=_.device)
        dist.recv(g, ctx.peer)
        return g, None


def send(x: Tensor, peer: int) -> Tensor:
    """Send x to the global rank `peer`; returns a zero scalar whose
    backward receives x's gradient from `peer`. Add it to the rank's
    output so that the backward reaches it."""
    return _Send.apply(x, peer)


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, peer, like):
        ctx.peer = peer
        buf = torch.empty_like(like)
        dist.recv(buf, peer)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.peer)
        return None, None, None


def recv(like: Tensor, peer: int, anchor: Tensor) -> Tensor:
    """A tensor shaped as `like`, received from the global rank `peer`;
    its backward sends the gradient back. `anchor` (any tensor that wants a
    gradient, or none) puts the receive on the autograd graph."""
    return _Recv.apply(anchor, peer, like)
