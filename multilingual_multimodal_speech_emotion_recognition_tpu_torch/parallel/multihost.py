"""Multi-process execution: one process per card, PyTorch's own idiom
(`torchrun`).

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
parallel/multihost.py. JAX drives a host's chips from one process and needs
several processes only across hosts; here every card has a process of its
own, so a JAX "process" and a JAX "device" are the same thing, a rank.
Every rank runs the same program the same number of times and feeds the
same collectives; this module supplies the pieces that keep that true:

  initialize()         brings up the process group from the flags or from
                       torchrun's environment (NCCL on cuda:LOCAL_RANK, gloo
                       on the CPU); a no-op without either; idempotent.
  HostShardedLoader    a rank's view of a GLOBAL bucketed epoch: every rank
                       builds the same plan and decodes only its data
                       shard's rows (the ranks of a 'model' group the same
                       rows), so the step counts agree by construction.
  put_sharded()        this rank's rows as a DTensor sharded on 'data'.
  local_rows()         this rank's rows of a row-sharded DTensor.
  allgather_rows()     a host array with a row count that differs per rank,
                       gathered over the 'data' ranks onto every rank, in
                       rank order or, batch by batch, in one process's row
                       order.
  host_replicated()    every DTensor leaf as the whole tensor (full_tensor),
                       so that the coordinator can write it.
  any_process()        True on every rank iff any rank set the flag.

With no process group, or a group of one rank, each degenerates to the
one-process path. Nothing here carries on on the CPU when the card or NCCL
is missing: a failed initialisation raises.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import BucketedLoader
from ..utils.runtime import map_leaves, resolve_device

Device = Optional[Union[str, torch.device]]

#: torchrun's environment: a process of a multi-process job
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device: Device = None) -> bool:
    """Bring up the process group if the flags or torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) describe one;
    a flag wins over its variable. NCCL with this process on
    cuda:LOCAL_RANK, or gloo where `device` is the CPU. Without flags or
    environment this is a no-op that returns False and touches nothing.
    Returns True iff a process group is up afterwards (a group of one rank
    included); a second call returns True at once. A group that cannot be
    brought up raises: a job that asked for several ranks never carries on
    as one."""
    if group_up():
        return True
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    env = os.environ
    if not explicit and not all(env.get(k) for k in _TORCHRUN_ENV):
        return False
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    rank = process_id if process_id is not None else env.get("RANK")
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    address = coordinator_address
    if address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    missing = [name for name, v in (("--process_id / RANK", rank),
                                    ("--num_processes / WORLD_SIZE", world),
                                    ("--coordinator_address / MASTER_ADDR:MASTER_PORT",
                                     address)) if v is None]
    if missing:
        raise ValueError(f"multi-process run: {', '.join(missing)} not given")
    rank, world = int(rank), int(world)
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", local)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank,
                            world_size=world, **kw)
    return True


def group_up() -> bool:
    """Whether a process group is up (the multi-process branches run)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the process group (1 without one)."""
    return dist.get_world_size() if group_up() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if group_up() else 0


def is_coordinator() -> bool:
    """Rank 0 owns every file: checkpoints, metrics and progress lines.
    The other ranks read its checkpoints back on resume."""
    return rank() == 0


def rank_device() -> torch.device:
    """The device this rank's collectives run on: its card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def any_process(flag: bool) -> bool:
    """True on every rank iff any rank passed True (an all-reduce with MAX).
    COLLECTIVE: every rank calls it at the same point. A SIGTERM lands at
    different steps on different ranks; a rank that left the step loop
    alone would wait in the checkpoint's collectives while the others wait
    in the step's."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=rank_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _all_gather(t: torch.Tensor, group, n: int) -> list:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return [p.cpu().numpy() for p in parts]


def allgather_rows(x: np.ndarray, *, mesh=None, batches=None) -> np.ndarray:
    """The host rows of every 'data' rank of `mesh` (of every rank without
    one) on every rank: the row counts are gathered first, then the rows
    padded to the largest count, and the padding stripped. In rank order;
    with `batches`, this rank's row count in each batch of its loader (every
    rank has as many batches), batch by batch instead: batch 0's rows of
    data rank 0, 1, ..., then batch 1's, which is one process's order of a
    HostShardedLoader's rows. The ranks of a 'model' group hold the same
    rows and are not gathered twice. So every rank computes the same
    metrics and the same Weibull fit. COLLECTIVE; the identity on one
    data rank."""
    from .mesh import DATA_AXIS
    group = None if mesh is None else mesh[DATA_AXIS].get_group()
    n = world_size() if mesh is None else mesh[DATA_AXIS].size()
    if n == 1:
        return x
    dev = rank_device()
    x = np.ascontiguousarray(x)
    per = np.asarray([x.shape[0]] if batches is None else batches, np.int64)
    counts = np.stack(_all_gather(torch.from_numpy(per).to(dev), group, n))
    totals = counts.sum(1)
    padded = torch.zeros((int(totals.max()),) + x.shape[1:],
                         dtype=torch.from_numpy(x).dtype, device=dev)
    padded[: x.shape[0]] = torch.from_numpy(x).to(dev)
    rows = [g[:t] for g, t in zip(_all_gather(padded, group, n), totals)]
    starts = np.cumsum(counts, axis=1) - counts
    return np.concatenate([rows[r][starts[r, b]: starts[r, b] + counts[r, b]]
                           for b in range(counts.shape[1]) for r in range(n)])


def put_sharded(x, mesh):
    """This rank's rows (a numpy array or tensor) as a DTensor of the global
    batch, sharded on 'data' and replicated on 'model'. Every rank of a
    data shard's model group passes the same rows; the row counts are
    equal across the data shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from .mesh import DATA_AXIS
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    t = t.to(_mesh_device(mesh))
    placements = [Shard(0) if name == DATA_AXIS else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(t, mesh, placements, run_check=False)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_rows(a) -> np.ndarray:
    """This rank's rows of a row-sharded DTensor, in global row order, with
    every other dimension whole (a leaf also sharded on a non-batch
    dimension is gathered there first); a plain tensor or array whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(a, DTensor):
        rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in a.placements]
        a = a.redistribute(a.device_mesh, rows).to_local()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def host_replicated(tree):
    """The tree with every DTensor leaf replaced by the whole tensor
    (full_tensor: an all-gather per sharded leaf), on the leaf's device.
    COLLECTIVE: every rank calls it; the identity on a tree without
    DTensors."""
    from torch.distributed.tensor import DTensor
    return map_leaves(tree, lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t)


def loader_class(mesh):
    """The loader of a run on `mesh`: each data shard's rows of the global
    batch (HostShardedLoader), or the whole batch without a mesh."""
    return functools.partial(HostShardedLoader, mesh=mesh) if mesh is not None else BucketedLoader


class HostShardedLoader(BucketedLoader):
    """A rank's view of a GLOBAL bucketed epoch.

    `batch_size` is the GLOBAL batch. Every rank builds the same global
    plan (BucketedLoader._plan depends only on the manifest, the seed and
    the epoch), then decodes, tokenises and assembles only the global rows
    [p * Bl, (p + 1) * Bl) of each batch (Bl = batch_size / P), the rows
    `put_sharded` gives this rank. P and p are `mesh`'s 'data' size and
    this rank's index on it where a mesh is given (the ranks of a 'model'
    group read the same rows), else `process_count` and `process_index`
    (one shard of a plan, as its tests build it). So every rank yields the
    same number of batches, each data shard decodes 1 / P of the audio, and
    a partial last batch pads each rank's block on its own (`example_mask`
    marks the real rows). `batches_per_epoch` stays the global count."""

    def __init__(self, dataset, *, batch_size: int, mesh=None,
                 process_index: int = 0, process_count: int = 1, **kw):
        if mesh is not None:
            from .mesh import DATA_AXIS
            process_index = mesh[DATA_AXIS].get_local_rank()
            process_count = mesh[DATA_AXIS].size()
        pi, pc = process_index, process_count
        if batch_size % pc:
            raise ValueError(f"global batch size {batch_size} not divisible by {pc} ranks")
        super().__init__(dataset, batch_size=batch_size, **kw)
        self.process_index, self.process_count = pi, pc
        self.batch_rows = batch_size // pc

    def _plan(self, epoch_idx: int):
        lo = self.process_index * self.batch_rows
        return [(bi, chunk[lo: lo + self.batch_rows])
                for bi, chunk in super()._plan(epoch_idx)]
