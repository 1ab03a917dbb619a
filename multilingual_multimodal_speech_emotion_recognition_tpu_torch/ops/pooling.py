"""Masked attentive-statistics pooling.

Counterpart of the JAX package's default path
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pooling.py:
attentive_stats_pooling): score MLP Linear(D,H) -> tanh -> Linear(H,1),
softmax over time with -inf on padded frames, then the weighted mean and a
two-pass weighted std, concatenated to [B, 2D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models import layers

Tensor = torch.Tensor


def init_attentive_stats_pooling(init: layers.Init, input_dim: int,
                                 hidden_dim: int = 128) -> dict:
    return {"w1": layers.init_linear(init, input_dim, hidden_dim),
            "w2": layers.init_linear(init, hidden_dim, 1)}


def attentive_stats_pooling(params: dict, x: Tensor,
                            mask: Optional[Tensor] = None, *,
                            eps: float = 1e-6) -> Tensor:
    """x: [B, S, D]; mask: [B, S] (1 valid / 0 pad). Returns [B, 2D]."""
    scores = layers.linear(params["w2"], torch.tanh(layers.linear(params["w1"], x)))
    scores = scores.squeeze(-1).float()
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -math.inf)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)[..., None]
    mean = (attn * x).sum(dim=1)
    var = (attn * (x - mean[:, None, :]).square()).sum(dim=1)
    return torch.cat([mean, torch.sqrt(var + eps)], dim=-1)
