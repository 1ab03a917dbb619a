"""Sequence parallelism: ring attention over a frame axis sharded on the
'model' ranks.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
parallel/sequence.py, in plain PyTorch as JAX's is jnp (no kernel behind
it). Each rank of a 'model' group holds a block of S / P frames; the key,
value and key-bias blocks go round the ring, one neighbour exchange a step
(`dist.batch_isend_irecv`, the next block's exchange started before the
current block's product), and each visiting block folds into an
online-softmax accumulator: the blockwise recurrence of the attention
kernel (ops/flash_attention.py), across ranks instead of across tiles.
Every rank sees every block once; per-frame work (LN, FFN, residuals) needs
no communication.

WavLM's gated bucketed bias is rebuilt each ring step from the global
(query, key) indices of the visiting block, so the dense [H, S, S] bias
never exists. S is zero-padded to a multiple of the ring size, the padded
frames masked out. The deterministic path only (eval, frozen backbones):
the ring has no backward, and a call that wants gradients raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import Wav2Vec2Config
from ..models import layers
from ..models import wav2vec2 as w2v
from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS

Tensor = torch.Tensor


def _ring_attention(q: Tensor, k: Tensor, v: Tensor, kv_bias: Tensor, group,
                    relpos: Optional[dict] = None) -> Tensor:
    """Blockwise ring attention over `group`.

    q, k, v: [B, H, S_loc, D] (q pre-scaled); kv_bias: [B, 1, 1, S_loc] f32,
    -inf on padded keys of this rank's block. Returns [B, H, S_loc, D]:
    softmax(q k^T + bias) v over the global key axis.

    relpos (WavLM): {"gate": [B, H, S_loc, 1] f32 per-query gate, "embed":
    [num_buckets, H], "num_buckets", "max_distance"}."""
    P = dist.get_world_size(group)
    my = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + 1) % P)
    prv = dist.get_global_rank(group, (my - 1) % P)
    B, H, Sq, D = q.shape
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    blocks = [k.contiguous(), v.contiguous(), kv_bias.float().contiguous()]
    q_pos = my * Sq + torch.arange(Sq)
    for step in range(P):
        pending = None
        if step < P - 1:
            nxt_blocks = [torch.empty_like(b) for b in blocks]
            ops = ([dist.P2POp(dist.isend, b, nxt, group) for b in blocks]
                   + [dist.P2POp(dist.irecv, b, prv, group) for b in nxt_blocks])
            pending = dist.batch_isend_irecv(ops)
        kk, vv, bb = blocks
        logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() + bb
        if relpos is not None:
            # after `step` rotations this rank holds block (my - step) mod P;
            # the buckets on the CPU, as models/wav2vec2.py takes them
            k_pos = ((my - step) % P) * Sq + torch.arange(Sq)
            bucket = w2v._relative_positions_bucket(
                k_pos[None, :] - q_pos[:, None], relpos["num_buckets"],
                relpos["max_distance"]).to(q.device)
            bias = relpos["embed"].float()[bucket].permute(2, 0, 1)
            logits = logits + relpos["gate"] * bias[None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # a query that has seen only masked keys so far has m_new = -inf:
        # exponentiate against 0 there so that alpha and p come out 0
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(m - m_safe)
        p = torch.exp(logits - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
        m = m_new
        if pending is not None:
            for req in pending:
                req.wait()
            blocks = nxt_blocks
    return (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def _layer_forward_sp(layer: dict, cfg: Wav2Vec2Config, x: Tensor, kv_bias: Tensor,
                      group, rel_embed: Optional[Tensor]) -> Tensor:
    """One encoder layer with ring attention; x: [B, S_loc, E]."""
    H = cfg.num_attention_heads
    D = cfg.hidden_size // H
    scale = D ** -0.5

    def attention(xin: Tensor) -> Tensor:
        B, S, E = xin.shape
        q = (layers.linear(layer["q"], xin) * scale).reshape(B, S, H, D)
        k = layers.linear(layer["k"], xin).reshape(B, S, H, D)
        v = layers.linear(layer["v"], xin).reshape(B, S, H, D)
        relpos = None
        if rel_embed is not None:
            # the per-(batch, head, query) gate of the dense stack
            # (models/wav2vec2._gated_bias): query-local, so made once here
            proj = layers.linear(layer["gru_lin"], xin.reshape(B, S, H, D))
            gates = torch.sigmoid(proj.reshape(B, S, H, 2, 4).sum(-1).float())
            ga, gb = gates[..., :1], gates[..., 1:]
            const = layer["gru_const"].float()[None, None, :, None]
            relpos = {"gate": (ga * (gb * const - 1.0) + 2.0).permute(0, 2, 1, 3),
                      "embed": rel_embed, "num_buckets": cfg.num_buckets,
                      "max_distance": cfg.max_bucket_distance}
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        ctx = _ring_attention(q, k, v, kv_bias, group, relpos)
        return layers.linear(layer["out"], ctx.permute(0, 2, 1, 3).reshape(B, S, E))

    def ffn(xin: Tensor) -> Tensor:
        # layers.gelu: the dense stack's per-dtype GELU, so both agree in bf16
        return layers.linear(layer["ffn_out"], layers.gelu(layers.linear(layer["ffn_in"], xin)))

    eps = cfg.layer_norm_eps
    if cfg.do_stable_layer_norm:
        x = x + attention(layers.layer_norm(layer["attn_ln"], x, eps=eps))
        return x + ffn(layers.layer_norm(layer["final_ln"], x, eps=eps))
    x = layers.layer_norm(layer["attn_ln"], x + attention(x), eps=eps)
    return layers.layer_norm(layer["final_ln"], x + ffn(x), eps=eps)


def encoder_stack_sequence_parallel(
        stacked: dict, cfg: Wav2Vec2Config, h: Tensor, frame_mask: Tensor, mesh, *,
        rel_attn_embed: Optional[Tensor] = None, seq_axis: str = MODEL_AXIS,
        batch_axis: Optional[str] = DATA_AXIS) -> Tensor:
    """The wav2vec2 transformer stack with the frame axis sharded on
    `seq_axis`.

    h: [B, S, E], the stack's input (wav2vec2_encode up to `_encoder_stack`),
    and frame_mask [B, S], the same on every rank; returns the stack's
    output [B, S, E] on every rank, equal to the dense `_encoder_stack` on
    the valid frames. Each rank computes its block of frames of its rows
    (`batch_axis` shards the rows; None: every data shard takes them all)
    and the blocks are gathered at the end. WavLM (cfg.gated_relpos_bias):
    pass `rel_attn_embed` (params["rel_attn_embed"], [num_buckets, H])."""
    if (rel_attn_embed is not None) != bool(cfg.gated_relpos_bias):
        raise ValueError("pass rel_attn_embed exactly when cfg.gated_relpos_bias is set")
    leaves = [h, *(t for t in _flat(stacked))]
    if rel_attn_embed is not None:
        leaves.append(rel_attn_embed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        raise RuntimeError("the ring attention stack has no backward: call it under "
                           "torch.no_grad() (the eval / frozen-backbone path)")
    seq = mesh[seq_axis]
    group = seq.get_group()
    P, my = seq.size(), seq.get_local_rank()
    B, S, E = h.shape
    S_pad = -(-S // P) * P
    if S_pad != S:
        h = F.pad(h, (0, 0, 0, S_pad - S))
        frame_mask = F.pad(frame_mask, (0, S_pad - S))
    if batch_axis is not None:
        rows = mesh[batch_axis]
        n, r = rows.size(), rows.get_local_rank()
        if B % n:
            raise ValueError(f"batch {B} not divisible by the '{batch_axis}' axis ({n})")
        h = h[r * (B // n):(r + 1) * (B // n)]
        frame_mask = frame_mask[r * (B // n):(r + 1) * (B // n)]
    S_loc = S_pad // P
    x = h[:, my * S_loc:(my + 1) * S_loc]
    kv_bias = layers.key_mask_bias(frame_mask[:, my * S_loc:(my + 1) * S_loc])
    for i in range(stacked["attn_ln"]["scale"].shape[0]):
        x = _layer_forward_sp(layers.layer_at(stacked, i), cfg, x, kv_bias, group,
                              rel_attn_embed)
    out = comm.gather_dim(x, 1, group)
    if batch_axis is not None:
        out = comm.gather_dim(out, 0, mesh[batch_axis].get_group())
    return out[:, :S]


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree
