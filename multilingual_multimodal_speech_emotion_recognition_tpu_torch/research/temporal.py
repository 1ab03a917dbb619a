"""Temporal modeling: positional encoding, causal TCN, confidence-aware
smoothing, speaker-change detection, sliding segment buffer.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
research/temporal.py, in plain PyTorch:
  * sin/cos positional encoding over <= 10 segment slots
  * causal conv (left pad (k-1)*dilation, LayerNorm over channels,
    dropout) and the 2-layer TCN 256 -> 128 -> 256 with dilations 1, 2,
    residual add and a final LayerNorm
  * confidence-aware smoothing: alpha = cur / (cur + hist); keep the
    current prediction outright when conf > 0.9; final conf =
    max(cur, hist) floored at 0.3
  * speaker change: cosine of projected consecutive embeddings < 0.7
  * the segment buffer as a fixed-shape carry (features, confidences,
    count), as the JAX module keeps it
The causal conv is a sum of matrix products over its taps, so that on the
card it runs in full f32 (a cuDNN conv would take TF32 by default).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers
from ..utils.runtime import resolve_device

Tensor = torch.Tensor

MAX_SEGMENTS = 10
BUFFER_SIZE = 3
SMOOTHING_THRESHOLD = 0.9
MIN_CONFIDENCE = 0.3
SPEAKER_CHANGE_THRESHOLD = 0.7


def positional_encoding(num_slots: int = MAX_SEGMENTS, dim: int = 256) -> np.ndarray:
    """Standard sin/cos PE table [num_slots, dim]."""
    pos = np.arange(num_slots)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((num_slots, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


# ------------------------------------------------------------- causal TCN

def init_causal_conv(init: layers.Init, in_ch: int, out_ch: int, kernel: int) -> dict:
    """w [out, in, kernel] with the JAX module's bound (its xavier takes
    fan_in = out and fan_out = kernel of that shape), zero bias, LN."""
    return {"w": init.uniform((out_ch, in_ch, kernel), layers.xavier_bound(out_ch, kernel)),
            "b": init.zeros((out_ch,)), "ln": layers.init_layer_norm(init, out_ch)}


def causal_conv(params: dict, x: Tensor, *, dilation: int = 1, dropout_rate: float = 0.1,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True) -> Tensor:
    """[B, S, C_in] -> [B, S, C_out], strictly causal (left padding)."""
    w = params["w"]
    kernel = w.shape[-1]
    pad = (kernel - 1) * dilation
    xp = F.pad(x, (0, 0, pad, 0))
    S = x.shape[1]
    y = sum(xp[:, k * dilation:k * dilation + S] @ w[:, :, k].T for k in range(kernel))
    y = layers.layer_norm(params["ln"], y + params["b"])
    return layers.dropout(generator, y, dropout_rate, deterministic)


def init_tcn(init: layers.Init, feature_dim: int = 256, hidden_dim: int = 128,
             kernel: int = 3) -> dict:
    return {"layer1": init_causal_conv(init, feature_dim, hidden_dim, kernel),
            "layer2": init_causal_conv(init, hidden_dim, feature_dim, kernel),
            "out_ln": layers.init_layer_norm(init, feature_dim)}


def tcn(params: dict, x: Tensor, *, dropout_rate: float = 0.1,
        generator: Optional[torch.Generator] = None, deterministic: bool = True) -> Tensor:
    """2-layer causal TCN with a residual. x: [B, S, feature_dim]."""
    drop = dict(dropout_rate=dropout_rate, generator=generator, deterministic=deterministic)
    h = torch.relu(causal_conv(params["layer1"], x, dilation=1, **drop))
    h = torch.relu(causal_conv(params["layer2"], h, dilation=2, **drop))
    return layers.layer_norm(params["out_ln"], x + h)


# -------------------------------------------------- confidence smoothing

def confidence_smoothing(current_pred: Tensor, current_conf: Tensor,
                         temporal_pred: Tensor, temporal_conf: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """(smoothed_pred, final_conf)."""
    current_conf = current_conf.clamp(0.0, 1.0)
    temporal_conf = temporal_conf.clamp(0.0, 1.0)
    alpha = current_conf / (current_conf + temporal_conf + 1e-8)
    keep = current_conf > SMOOTHING_THRESHOLD
    smoothed = torch.where(keep, current_pred,
                           alpha * current_pred + (1 - alpha) * temporal_pred)
    final_conf = torch.maximum(current_conf, temporal_conf)
    return smoothed, final_conf.clamp(min=MIN_CONFIDENCE)


# ------------------------------------------------- speaker change detector

def init_speaker_detector(init: layers.Init, embed_dim: int = 256,
                          proj_dim: int = 128) -> dict:
    return {"proj": layers.init_linear(init, embed_dim, proj_dim)}


def speaker_change(params: dict, prev_embed: Tensor, cur_embed: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """(changed [B] bool, similarity [B]): cosine of projections < 0.7."""
    a = layers.linear(params["proj"], prev_embed)
    b = layers.linear(params["proj"], cur_embed)
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=1e-8)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp(min=1e-8)
    sim = (a * b).sum(-1)
    return sim < SPEAKER_CHANGE_THRESHOLD, sim


# --------------------------------------------------------- segment buffer

class TemporalBufferState(NamedTuple):
    """Ring buffer of segment features / confidences and its fill count."""
    features: Tensor     # [B, BUFFER_SIZE, D]
    confidences: Tensor  # [B, BUFFER_SIZE]
    count: Tensor        # [B] int32 (saturates at BUFFER_SIZE)


def init_buffer(B: int, dim: int, size: int = BUFFER_SIZE,
                device: Optional[Union[str, torch.device]] = None) -> TemporalBufferState:
    """An empty buffer; on the card unless `device` says otherwise."""
    device = resolve_device(device)
    return TemporalBufferState(
        features=torch.zeros(B, size, dim, device=device),
        confidences=torch.zeros(B, size, device=device),
        count=torch.zeros(B, dtype=torch.int32, device=device))


def buffer_push(state: TemporalBufferState, feat: Tensor, conf: Tensor
                ) -> TemporalBufferState:
    """Append a segment (shift left; the oldest drops once full)."""
    features = torch.cat([state.features[:, 1:], feat[:, None]], dim=1)
    confs = torch.cat([state.confidences[:, 1:], conf[:, None]], dim=1)
    count = (state.count + 1).clamp(max=state.features.shape[1])
    return TemporalBufferState(features=features, confidences=confs, count=count)


def buffer_valid_mask(state: TemporalBufferState) -> Tensor:
    """[B, size] mask over filled slots (newest at the end)."""
    size = state.features.shape[1]
    slots = torch.arange(size, device=state.count.device)
    return (slots[None, :] >= (size - state.count[:, None])).float()


# ------------------------------------------------------------ full module

def init_temporal_module(feature_dim: int = 256, num_emotions: int = 4, *,
                         generator: Optional[torch.Generator] = None,
                         device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random parameters with the JAX module's tree, shapes and init
    distributions; `generator` lives on `device` (None seeds one with 0),
    the card unless `device` says otherwise."""
    device = resolve_device(device)
    init = layers.Init(generator, device)
    return {
        "tcn": init_tcn(init, feature_dim, feature_dim // 2),
        "speaker": init_speaker_detector(init, feature_dim),
        "emotion_head": layers.init_linear(init, feature_dim, num_emotions),
        "conf_head": layers.init_linear(init, feature_dim, 1),
        "pe": torch.from_numpy(positional_encoding(MAX_SEGMENTS, feature_dim)).to(device),
    }


def temporal_step(params: dict, state: TemporalBufferState, feat: Tensor, conf: Tensor,
                  *, deterministic: bool = True,
                  generator: Optional[torch.Generator] = None):
    """One segment through the module: push -> PE -> TCN over the buffered
    window -> heads -> confidence smoothing. Returns (new_state,
    smoothed_logits [B, C], final_conf [B, 1], info)."""
    new_state = buffer_push(state, feat, conf[:, 0])
    mask = buffer_valid_mask(new_state)                       # [B, W]
    window = new_state.features + params["pe"][:mask.shape[1]][None]
    h = tcn(params["tcn"], window, deterministic=deterministic, generator=generator)
    current = h[:, -1]                                        # newest slot
    logits = layers.linear(params["emotion_head"], current)
    cur_conf = torch.sigmoid(layers.linear(params["conf_head"], current))

    # historical average over the slots filled before (not the current one)
    hist_mask = mask.clone()
    hist_mask[:, -1] = 0.0
    denom = hist_mask.sum(-1, keepdim=True).clamp(min=1.0)
    hist_conf = (new_state.confidences * hist_mask).sum(-1, keepdim=True) / denom
    hist_logits = layers.linear(params["emotion_head"],
                                (h * hist_mask[..., None]).sum(1) / denom)

    smoothed, final_conf = confidence_smoothing(logits, cur_conf, hist_logits, hist_conf)
    prev_feat = state.features[:, -1]
    changed, sim = speaker_change(params["speaker"], prev_feat, feat)
    # first segment: no previous speaker, so no change
    changed = changed & (state.count > 0)
    info = {"speaker_changed": changed, "speaker_similarity": sim,
            "current_confidence": cur_conf, "historical_confidence": hist_conf}
    return new_state, smoothed, final_conf, info
