"""The device mesh and the sharding rules of the parameters and batches.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
parallel/mesh.py, over torch.distributed's DeviceMesh and DTensor: a
('data', 'model') mesh over the process group's ranks (one rank per card),
batches sharded on 'data', parameters laid out by the JAX package's rules
(`_param_pspec`: the big backbone matrices on 'model', Megatron's pairing;
`_fsdp_pspec`: ZeRO, the largest free dimension on 'data'), as per-mesh-
dimension placements (Shard(d) / Replicate()).

What the placements decide is where each parameter, gradient and AdamW
moment lives. The train step (train/train_step.py) takes each rank's view
of the parameters (parallel/tensor.local_params: a dimension FSDP put on
'data' gathered over 'data', a leaf the 'model' rule shards left as this
rank's shard), runs the forward and backward on this rank's rows, with the
encoders and the cross-modal attention split over the 'model' group as
Megatron splits them (parallel/tensor.py: q/k/v and ffn_in column-parallel,
out and ffn_out row-parallel, pos_conv by its groups; the rest
replicated), gathers the rows' outputs so that the loss is the global
batch's, and reduces the gradients back to the parameters' placements (a
reduce-scatter or all-reduce over 'data'); the optimizer then updates each
rank's shards. So the arithmetic is the one-process step's on the global
batch, and a 'model' axis of N splits the matmuls of the sharded leaves N
ways, as GSPMD splits them in the JAX package. The ranks of a 'model'
group read the same rows (multihost.HostShardedLoader on 'data''s rank and
size).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.runtime import leaves_with_paths, map_leaves, resolve_device
from . import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)

#: Leaves smaller than this replicate even under FSDP: gathering a tiny
#: norm or bias costs a collective launch and saves no meaningful memory.
FSDP_MIN_SIZE = 2 ** 15

#: a JAX-style spec: for each tensor dimension the mesh axis it is sharded
#: on, or None
Spec = Tuple[Optional[str], ...]


def make_mesh(data: int = -1, model: int = 1, *, dcn_data: int = 1,
              device: Optional[Union[str, torch.device]] = None):
    """A ('data', 'model') DeviceMesh over the process group's ranks, of
    shape (dcn_data * data, model); data=-1 takes the ranks left over.
    Ranks go row-major: a 'model' group is `model` consecutive ranks, and
    the dcn_data groups of data * model ranks (one host or slice each, as
    torchrun numbers ranks host by host) are folded slice-major into
    'data', so that only the gradient reduction crosses them. The card
    unless `device` says otherwise; the group must be up
    (multihost.initialize)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: launch with torchrun or "
                           "call parallel.multihost.initialize first")
    n = dist.get_world_size()
    if data == -1:
        if n % (model * dcn_data):
            raise ValueError(f"{n} ranks do not divide into model {model} x dcn {dcn_data}")
        data = n // (model * dcn_data)
    if data * model * dcn_data != n:
        raise ValueError(f"dcn {dcn_data} x data {data} x model {model} != {n} ranks")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, (dcn_data * data, model), mesh_dim_names=AXES)


def mesh_from_config(mcfg, device: Optional[Union[str, torch.device]] = None):
    """The mesh a config.MeshConfig describes."""
    return make_mesh(data=mcfg.data_axis, model=mcfg.model_axis,
                     dcn_data=mcfg.dcn_data, device=device)


# ---------------------------------------------------------------- rules

def _param_pspec(path: str, shape: Sequence[int]) -> Spec:
    """The 'model'-axis rule of the JAX package for the leaf at `path`
    (its "/"-joined keys): big kernels shard their output dimension
    (column parallel: ffn_in and the q/k/v projections) or their input
    dimension (row parallel: ffn_out and the attention output); the rest
    replicates. The port's layouts are JAX's for every leaf this rule
    shards (linear kernels stay [in, out])."""
    ndim = len(shape)
    if ndim >= 2 and "kernel" in path:
        if ("ffn_in" in path or path.endswith("q/kernel") or path.endswith("k/kernel")
                or path.endswith("v/kernel")):
            return (None,) * (ndim - 1) + (MODEL_AXIS,)
        if "ffn_out" in path or "out/kernel" in path:
            return (None,) * (ndim - 2) + (MODEL_AXIS, None)
    return (None,) * ndim


def _conv_kernel(path: str) -> bool:
    """The conv kernels whose layout is torch's [C_out, C_in/g, K], the
    reverse of JAX's [K, C_in/g, C_out] (weights.py)."""
    keys = path.split("/")
    return keys[-1] == "kernel" and ("convs" in keys or "pos_conv" in keys)


def _fsdp_pspec(spec: Spec, shape: Sequence[int], n: int, min_size: int) -> Spec:
    """ZeRO's extension of a spec: the largest still-unsharded dimension
    that `n` divides goes on 'data' (the first such on a tie). Leaves under
    `min_size` elements, and every leaf when n <= 1, keep `spec`."""
    size = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    if size < max(min_size, 1) or n <= 1:
        return spec
    best = None
    for d in range(len(shape)):
        if spec[d] is not None or shape[d] % n or shape[d] < n:
            continue
        if best is None or shape[d] > shape[best]:
            best = d
    if best is None:
        return spec
    return tuple(DATA_AXIS if d == best else spec[d] for d in range(len(shape)))


def leaf_spec(path: str, shape: Sequence[int], *, n_data: int, fsdp: bool,
              fsdp_min_size: Optional[int] = None) -> Spec:
    """The spec of one leaf: the 'model' rule, then ZeRO's where `fsdp`.
    A conv kernel is judged in JAX's layout and its spec reversed, so that
    it shards the same logical dimensions as there (JAX's rule takes
    `pos_conv/kernel` for a "v/kernel" and shards its output channels on
    'model'; so does this one)."""
    conv = _conv_kernel(path)
    if conv:
        shape = tuple(reversed(shape))
    spec = _param_pspec(path, shape)
    if fsdp:
        spec = _fsdp_pspec(spec, shape, n_data,
                           FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size)
    return tuple(reversed(spec)) if conv else spec


def placements(spec: Spec, mesh_dim_names: Sequence[str] = AXES):
    """Per mesh dimension: Shard(d) for the tensor dimension d the spec
    puts on it, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _leaf_placements(mesh, *, fsdp: bool, fsdp_min_size: Optional[int]):
    n_data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    return lambda path, t: placements(
        leaf_spec(path, tuple(t.shape), n_data=n_data, fsdp=fsdp,
                  fsdp_min_size=fsdp_min_size), mesh.mesh_dim_names)


def param_shardings(params: dict, mesh, *, fsdp: bool = False,
                    fsdp_min_size: Optional[int] = None) -> dict:
    """The placements (a tuple per leaf, one placement per mesh dimension)
    of every leaf of a parameter tree on this mesh."""
    return map_leaves(params, _leaf_placements(mesh, fsdp=fsdp, fsdp_min_size=fsdp_min_size))


def shard_params(params: dict, mesh, *, fsdp: bool = False,
                 fsdp_min_size: Optional[int] = None) -> dict:
    """The tree as DTensors under param_shardings, with rank 0's values (a
    DTensor leaf is gathered whole first; each leaf is broadcast from rank
    0, then every rank keeps its shard, so the only collective is a
    broadcast). A leaf whose sharded dimension the mesh axis does not divide
    raises, naming it. COLLECTIVE."""
    from torch.distributed.tensor import DTensor, Shard
    layout = _leaf_placements(mesh, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
    coord = mesh.get_coordinate()
    world = dist.get_world_size()

    def put(path, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().to(multihost._mesh_device(mesh)).contiguous()
        if world > 1:
            t = t.clone()
            dist.broadcast(t, src=0)
        pls = layout(path, t)
        for axis, pl in enumerate(pls):
            if isinstance(pl, Shard):
                n = mesh.size(axis)
                if t.shape[pl.dim] % n:
                    raise ValueError(f"{path}: the '{mesh.mesh_dim_names[axis]}' axis of {n} "
                                     f"does not divide its dimension {pl.dim} of "
                                     f"{t.shape[pl.dim]}")
                t = t.chunk(n, dim=pl.dim)[coord[axis]]
        return DTensor.from_local(t.contiguous(), mesh, pls, run_check=False)
    return map_leaves(params, put)


def shard_like(tree: dict, like: dict) -> dict:
    """`tree`'s whole tensors laid out as `like`'s DTensor leaves at the
    same paths (a leaf of `like` that is no DTensor leaves its counterpart
    as it is): a restored optimizer state or a new Weibull fit onto the
    running layout. COLLECTIVE."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    ref = dict(leaves_with_paths(like))

    def put(path, t):
        r = ref.get(path)
        if not isinstance(r, DTensor):
            return t
        return distribute_tensor(t.detach().to(r.dtype), r.device_mesh, r.placements)
    return map_leaves(tree, put)


# ---------------------------------------------------------------- batches

def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a batch (the tensors data/prefetch.device_prefetch
    put on the card) as DTensors of the global batch, sharded on 'data'
    (multihost.put_sharded). The JAX package's int16 audio wire has no
    counterpart here: the port's host-to-card copy is device_prefetch's,
    which runs before this."""
    return {k: multihost.put_sharded(v, mesh) for k, v in batch.items()}
