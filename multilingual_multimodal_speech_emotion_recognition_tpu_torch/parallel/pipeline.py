"""Pipeline parallelism: the encoder stack staged over the 'model' ranks.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
parallel/pipeline.py. The L transformer layers split into P contiguous
stages, stage p on the p-th rank of a 'model' group holding layers
[p L / P, (p + 1) L / P), and microbatches stream through them GPipe's way:
at step t stage p runs microbatch t - p and sends its [mb, S, E] block to
stage p + 1, for M + P - 1 steps (M microbatches, P - 1 bubble steps; a
stage skips the steps where it has no microbatch, where JAX's SPMD scan
computes and masks). Each stage runs the dense stack's own layer math
(models/wav2vec2._encoder_stack) on its layers. The last stage's outputs
reach every rank by a broadcast over the group, and the data shards' rows
by a gather.

Differentiable: each hop is an autograd function whose backward sends the
gradient back a stage (parallel/comm.py), and the inputs' gradients are
summed over the ranks, so every rank gets the dense stack's gradients.
`remat_stage` recomputes a stage's activations in the backward
(torch.utils.checkpoint), keeping one microbatch's a stage. Deterministic
path only, as in JAX: no dropout inside the stages.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from ..config import Wav2Vec2Config
from ..models import layers
from ..models import wav2vec2 as w2v
from ..ops import _build
from ..utils.runtime import leaves_with_paths, map_leaves
from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS

Tensor = torch.Tensor


def encoder_stack_pipeline(
        stacked: dict, cfg: Wav2Vec2Config, h: Tensor, frame_mask: Tensor, mesh, *,
        num_microbatches: int, rel_attn_embed: Optional[Tensor] = None,
        pipe_axis: str = MODEL_AXIS, batch_axis: Optional[str] = DATA_AXIS,
        remat_stage: bool = True) -> Tensor:
    """The wav2vec2 transformer stack pipelined over `pipe_axis`.

    h: [B, S, E], the stack's input, and frame_mask [B, S], the same on
    every rank; returns the stack's output [B, S, E] on every rank, equal
    to the dense `_encoder_stack`. B must divide by num_microbatches, each
    microbatch's rows by the `batch_axis` size (None: every data shard runs
    all rows), the layer count by the stage count. WavLM
    (cfg.gated_relpos_bias): pass params["rel_attn_embed"]; the [H, S, S]
    bias is made once and shared (S is not sharded here)."""
    w2v.check_supported(cfg)
    if (rel_attn_embed is not None) != bool(cfg.gated_relpos_bias):
        raise ValueError("pass rel_attn_embed exactly when cfg.gated_relpos_bias is set")
    B, S, E = h.shape
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    n_rows, row = 1, 0
    if batch_axis is not None:
        n_rows, row = mesh[batch_axis].size(), mesh[batch_axis].get_local_rank()
        if (B // M) % n_rows:
            raise ValueError(f"per-microbatch rows {B // M} not divisible by the "
                             f"'{batch_axis}' axis ({n_rows}); lower num_microbatches "
                             "or pass batch_axis=None")
    pipe = mesh[pipe_axis]
    P, my = pipe.size(), pipe.get_local_rank()
    L = stacked["attn_ln"]["scale"].shape[0]
    if L % P:
        raise ValueError(f"{L} layers not divisible by {P} pipeline stages")

    # the inputs' gradients summed over every rank (each finds only its
    # stage's and rows' share); every rank uses its stage's slice of the
    # layers, so every rank's backward reaches the sum
    paths = [p for p, _ in leaves_with_paths(stacked)]
    ins = [h, *(t for _, t in leaves_with_paths(stacked))]
    if rel_attn_embed is not None:
        ins.append(rel_attn_embed)
    grads_wanted = _build.grad_wanted(ins)
    if grads_wanted:
        groups = [mesh[a].get_group() for a in mesh.mesh_dim_names if mesh[a].size() > 1]
        ins = comm.replicated_in(groups, *ins)
    h, leaves = ins[0], dict(zip(paths, ins[1:1 + len(paths)]))
    if rel_attn_embed is not None:
        rel_attn_embed = ins[-1]
    lo, hi = my * (L // P), (my + 1) * (L // P)
    stage = map_leaves(stacked, lambda path, _: leaves[path][lo:hi])

    mbl = B // M // n_rows
    x = h.reshape(M, B // M, S, E)[:, row * mbl:(row + 1) * mbl]
    bias = layers.key_mask_bias(
        frame_mask.reshape(M, B // M, S)[:, row * mbl:(row + 1) * mbl].reshape(-1, S)
    ).reshape(M, mbl, 1, 1, S)
    pos_bias = (w2v.relative_position_bias({"rel_attn_embed": rel_attn_embed}, cfg, S)
                if rel_attn_embed is not None else None)

    def apply_stage(buf: Tensor, b: Tensor) -> Tensor:
        return w2v._encoder_stack(stage, cfg, buf, b, deterministic=True, pos_bias=pos_bias)

    run = apply_stage
    if remat_stage and grads_wanted:
        run = lambda buf, b: ckpt.checkpoint(apply_stage, buf, b, use_reentrant=False)

    group = pipe.get_group()
    nxt = prv = None
    if my < P - 1:
        nxt = torch.distributed.get_global_rank(group, my + 1)
    if my > 0:
        prv = torch.distributed.get_global_rank(group, my - 1)
    anchor = h if grads_wanted else None
    outs, sent = [None] * M, []
    buf = None
    for t in range(M + P - 1):
        idx = t - my
        if 0 <= idx < M:
            if my == 0:
                buf = x[idx]
            y = run(buf, bias[idx])
            if my == P - 1:
                outs[idx] = y
            else:
                sent.append(comm.send(y, nxt))
        if my > 0 and 0 <= t + 1 - my < M:
            buf = comm.recv(x[0], prv, anchor)
    if my == P - 1:
        out = torch.stack(outs)
    else:
        # a placeholder the broadcast overwrites; it holds the sends' (zero)
        # handles and x, so that this rank's backward reaches both
        out = x * 0.0
    for s in sent:
        out = out + s
    if P > 1:
        out = comm.broadcast(out, torch.distributed.get_global_rank(group, P - 1), group)
    if batch_axis is not None:
        out = comm.gather_dim(out, 1, mesh[batch_axis].get_group())
    return out.reshape(B, S, E)
