"""Bidirectional cross-modal attention: audio queries text and text queries
audio, each direction through a shared space with key-padding masks, then
residual + LayerNorm. In training, dropout at cross_dropout on each
direction's attention weights and on its output before the residual.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/cross_attention.py; the attention is layers.mha, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import layers

Tensor = torch.Tensor


def init_cross_modal_attention(init: layers.Init, audio_dim: int,
                               text_dim: int, shared_dim: int = 256) -> dict:
    return {
        "q_a": layers.init_linear(init, audio_dim, shared_dim),
        "k_t": layers.init_linear(init, text_dim, shared_dim),
        "v_t": layers.init_linear(init, text_dim, shared_dim),
        "attn_a": layers.init_mha(init, shared_dim),
        "out_a": layers.init_linear(init, shared_dim, audio_dim),
        "q_t": layers.init_linear(init, text_dim, shared_dim),
        "k_a": layers.init_linear(init, audio_dim, shared_dim),
        "v_a": layers.init_linear(init, audio_dim, shared_dim),
        "attn_t": layers.init_mha(init, shared_dim),
        "out_t": layers.init_linear(init, shared_dim, text_dim),
        "norm_a": layers.init_layer_norm(init, audio_dim),
        "norm_t": layers.init_layer_norm(init, text_dim),
    }


def cross_modal_attention(params: dict, audio_seq: Tensor, text_seq: Tensor,
                          audio_mask: Optional[Tensor] = None,
                          text_mask: Optional[Tensor] = None, *,
                          num_heads: int = 8, dropout_rate: float = 0.1,
                          generator: Optional[torch.Generator] = None,
                          deterministic: bool = True, tp=None) -> Tuple[Tensor, Tensor]:
    """audio_seq: [B, Sa, Da]; text_seq: [B, St, Dt]; masks 1 valid / 0 pad.
    Returns (audio_enhanced [B, Sa, Da], text_enhanced [B, St, Dt]). Under
    `tp` (a parallel/tensor.ModelGroup) attn_a and attn_t run this rank's
    heads (layers.mha); the shared-space projections, which the 'model'
    rule leaves replicated, run whole on every rank."""
    drop = dict(dropout_rate=dropout_rate, generator=generator, deterministic=deterministic,
                tp=tp)
    a_ctx = layers.mha(params["attn_a"], layers.linear(params["q_a"], audio_seq),
                       layers.linear(params["k_t"], text_seq),
                       layers.linear(params["v_t"], text_seq),
                       num_heads=num_heads, key_padding_mask=text_mask, **drop)
    a_out = layers.dropout(generator, layers.linear(params["out_a"], a_ctx),
                           dropout_rate, deterministic)
    audio_enh = layers.layer_norm(params["norm_a"], audio_seq + a_out)

    t_ctx = layers.mha(params["attn_t"], layers.linear(params["q_t"], text_seq),
                       layers.linear(params["k_a"], audio_seq),
                       layers.linear(params["v_a"], audio_seq),
                       num_heads=num_heads, key_padding_mask=audio_mask, **drop)
    t_out = layers.dropout(generator, layers.linear(params["out_t"], t_ctx),
                           dropout_rate, deterministic)
    text_enh = layers.layer_norm(params["norm_t"], text_seq + t_out)
    return audio_enh, text_enh
