"""Tensor parallelism on the mesh's 'model' axis: Megatron's column / row
split of the encoders and the cross-modal attention.

The JAX package has no counterpart: there GSPMD splits the matmuls of the
parameters that parallel/mesh.py's rule puts on 'model'. Here the forward
does it by hand over the 'model' group of the mesh (a ModelGroup):

  * q, k, v and ffn_in are column-parallel: each rank holds its heads'
    (its columns') slice of the kernel and computes its heads' attention,
    or its columns of the FFN, alone;
  * out and ffn_out are row-parallel: each rank multiplies its heads' (its
    columns') activations by its rows of the kernel, the partial products
    are summed over the group (`reduce_from_model`) and the bias added
    once, after the sum;
  * the input of a column-parallel block goes through `copy_to_model`, so
    that its gradient sums the ranks' shares; LN, residuals, pooling,
    fusion and the classifier stay replicated.

A replicated leaf that a rank uses only in part (the q/k/v and ffn_in
biases, WavLM's gate constants and bias table, pos_conv's bias) is cut to
this rank's part through `copy_to_model` too, so its gradient is whole on
every rank, as a replicated leaf's must be. The gradient of a sharded leaf
is this rank's shard's; train/train_step.reduce_grads lays each out on its
leaf's own placements.

Every collective here is an all-reduce (the all-gather of `gather_from_model`
is one over a zero-padded buffer), so a group of gloo ranks sharing one card
carries them as well as NCCL. A group of one rank runs the same code with no
collective and gives the unsharded forward bitwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.runtime import map_leaves
from .mesh import DATA_AXIS, MODEL_AXIS

Tensor = torch.Tensor


class ModelGroup:
    """This rank's place in its 'model' group: the process group, this
    rank's index in it and its size. `span(n, what)` is the slice of n
    (heads, columns, conv groups) this rank owns; it raises, naming
    `what`, where the size does not divide n."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, rank, size

    def span(self, n: int, what: str) -> Tuple[int, int]:
        if n % self.size:
            raise ValueError(f"{what}: {n} is not divisible by the 'model' axis of "
                             f"{self.size}")
        part = n // self.size
        return self.rank * part, (self.rank + 1) * part


def model_group(mesh) -> ModelGroup:
    """The ModelGroup of this rank on `mesh`."""
    sub = mesh[MODEL_AXIS]
    return ModelGroup(sub.get_group(), sub.get_local_rank(), sub.size())


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.lo, ctx.n = dim, tp.rank * x.shape[dim], x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= tp.size
        full = x.new_zeros(shape)
        full.narrow(dim, ctx.lo, ctx.n).copy_(x)
        dist.all_reduce(full, group=tp.group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None


def copy_to_model(x: Tensor, tp: ModelGroup) -> Tensor:
    """x as it is; in the backward, its gradient summed over the group (the
    input of a column-parallel block, or a replicated leaf cut to this
    rank's part)."""
    return x if tp.size == 1 else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: Tensor, tp: ModelGroup) -> Tensor:
    """The sum of the group's x (a row-parallel product's partial sums); the
    gradient passes as it is."""
    return x if tp.size == 1 else _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: Tensor, dim: int, tp: ModelGroup) -> Tensor:
    """The group's equal blocks of x joined along `dim` in rank order; the
    backward keeps this rank's block of the (replicated) cotangent."""
    return x if tp.size == 1 else _GatherFromModel.apply(x, dim, tp)


def local_part(x: Tensor, dim: int, span: Tuple[int, int], tp: ModelGroup) -> Tensor:
    """This rank's part [lo, hi) along `dim` of a replicated x, through
    copy_to_model so that x's gradient is whole on every rank."""
    lo, hi = span
    return copy_to_model(x, tp).narrow(dim, lo, hi - lo)


def row_linear(p: dict, x: Tensor, tp: ModelGroup) -> Tensor:
    """The row-parallel product: this rank's columns of x by its rows of the
    kernel, summed over the group, then the bias once."""
    y = reduce_from_model(torch.matmul(x, p["kernel"]), tp)
    if "bias" in p:
        y = y + p["bias"]
    return y


def check_model_axis(cfg, size: int) -> None:
    """Raise, naming the leaf, where a 'model' axis of `size` does not divide
    a dimension the forward splits: the heads of each encoder and of the
    cross-modal attention, the FFN widths and pos_conv's groups (cfg: a
    config.ModelConfig)."""
    if size <= 1:
        return
    a, t = cfg.audio, cfg.text
    dims = (("audio_backbone/layers/q/kernel", "heads", a.num_attention_heads),
            ("audio_backbone/layers/ffn_in/kernel", "columns", a.intermediate_size),
            ("audio_backbone/pos_conv/kernel", "groups", a.num_conv_pos_embedding_groups),
            ("text_backbone/layers/q/kernel", "heads", t.num_attention_heads),
            ("text_backbone/layers/ffn_in/kernel", "columns", t.intermediate_size),
            ("cross/attn_a/q/kernel", "heads", cfg.num_heads),
            ("cross/attn_t/q/kernel", "heads", cfg.num_heads))
    bad = [f"{path}'s {n} {what}" for path, what, n in dims if n % size]
    if bad:
        raise ValueError(f"the 'model' axis of {size} does not divide {', '.join(bad)}")


def mesh_of(params: dict):
    """The mesh of a tree of DTensors (parallel/mesh.shard_params), or None
    for plain tensors."""
    from torch.distributed.tensor import DTensor
    leaf = params["classifier"]["input_proj"]["kernel"]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


@torch.no_grad()
def local_params(params: dict, mesh) -> dict:
    """This rank's view of a tree of DTensors: a leaf the 'model' rule
    shards is this rank's shard, a dimension FSDP put on 'data' is gathered
    over 'data' alone (an all-gather of that axis), every other leaf whole;
    a plain tensor as it is. Nothing is gathered over 'model'. No gradient
    flows through the view."""
    from torch.distributed.tensor import DTensor, Replicate

    def view(_, t):
        if not isinstance(t, DTensor):
            return t
        want = [pl if name == MODEL_AXIS else Replicate()
                for name, pl in zip(mesh.mesh_dim_names, t.placements)]
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()
    return map_leaves(params, view)


def split(params: dict) -> Tuple[dict, Optional[ModelGroup]]:
    """(this rank's view, its ModelGroup) of a tree sharded on a mesh, or
    (params, None) for plain tensors: what the eval forwards take."""
    mesh = mesh_of(params)
    if mesh is None:
        return params, None
    return local_params(params, mesh), model_group(mesh)


def data_shard(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's data shard: the loader's rows."""
    sub = mesh[DATA_AXIS]
    return sub.get_local_rank(), sub.size()
