"""Gated modality fusion: project the pooled audio and text vectors to
proj_dim with 2-layer MLPs, gate each with a sigmoid, normalise the two
gates and return the weighted sum. In training, dropout at fusion_dropout
after each projection's ReLU.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/fusion.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers

Tensor = torch.Tensor


def init_fusion(init: layers.Init, audio_dim: int, text_dim: int,
                proj_dim: int) -> dict:
    gate_hidden = max(32, proj_dim // 2)
    return {
        "proj_a1": layers.init_linear(init, audio_dim, proj_dim),
        "proj_a2": layers.init_linear(init, proj_dim, proj_dim),
        "proj_t1": layers.init_linear(init, text_dim, proj_dim),
        "proj_t2": layers.init_linear(init, proj_dim, proj_dim),
        "gate_a1": layers.init_linear(init, proj_dim, gate_hidden),
        "gate_a2": layers.init_linear(init, gate_hidden, 1),
        "gate_t1": layers.init_linear(init, proj_dim, gate_hidden),
        "gate_t2": layers.init_linear(init, gate_hidden, 1),
    }


def fusion(params: dict, audio_vec: Tensor, text_vec: Tensor, *,
           dropout_rate: float = 0.1, generator: Optional[torch.Generator] = None,
           deterministic: bool = True) -> Tensor:
    """audio_vec: [B, Da], text_vec: [B, Dt] -> fused [B, proj_dim]."""
    def proj(first, second, x):
        h = torch.relu(layers.linear(params[first], x))
        h = layers.dropout(generator, h, dropout_rate, deterministic)
        return layers.linear(params[second], h)

    a = proj("proj_a1", "proj_a2", audio_vec)
    t = proj("proj_t1", "proj_t2", text_vec)
    wa = torch.sigmoid(layers.linear(
        params["gate_a2"], torch.relu(layers.linear(params["gate_a1"], a))))
    wt = torch.sigmoid(layers.linear(
        params["gate_t2"], torch.relu(layers.linear(params["gate_t1"], t))))
    wsum = wa + wt + 1e-8
    return (wa / wsum) * a + (wt / wsum) * t
