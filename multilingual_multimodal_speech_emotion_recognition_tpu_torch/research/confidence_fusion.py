"""Confidence-aware fusion: the dynamic gating MLP, the policy clamps and
the adaptive fusion layer, in plain PyTorch.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
research/confidence_fusion.py:
  * the 14 confidence scalars and their normalisations (`to_array`)
  * the gating MLP 14 -> 32 -> 16 -> 2, softmax; its output layer starts
    at zero, so the two weights start equal
  * the five policy clamps, vectorised over the batch with torch.where
  * the adaptive fusion layer: per-modality projections (Linear -> ReLU ->
    Dropout -> LN -> Linear), the gated weighted sum, the 14 -> 32 ->
    proj/4 confidence projection concatenated, the fusion projection and
    the sigmoid fusion-confidence head
Dropout draws from one torch.Generator on the tensors' device; the
parameters are made on the card unless `device` says otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..models import layers
from ..utils.runtime import resolve_device

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]

CONFIDENCE_DIM = 14

SNR_LOW = 10.0
ASR_CONF_LOW = 0.5
LID_ENTROPY_HIGH = 1.5
SPEECH_PROB_LOW = 0.7


class ConfidenceFeatures(NamedTuple):
    """Raw (unnormalised) per-utterance confidence scalars, each [B]."""
    snr_db: Tensor
    speech_prob: Tensor
    clipping_percent: Tensor
    denoise_gain_db: Tensor
    asr_conf_segment: Tensor
    lid_entropy: Tensor
    text_reliability_score: Tensor
    conditioning_applied: Tensor
    quality_gates_passed: Tensor
    audio_text_similarity: Tensor
    boundary_confidence: Tensor
    segment_emotion_consistency: Tensor
    previous_segment_confidence: Tensor
    emotion_transition_probability: Tensor

    def to_array(self) -> Tensor:
        """The normalised [B, 14] vector."""
        return torch.stack([
            self.snr_db / 50.0,
            self.speech_prob,
            self.clipping_percent / 100.0,
            self.denoise_gain_db / 20.0,
            self.asr_conf_segment,
            self.lid_entropy / 2.0,
            self.text_reliability_score,
            self.conditioning_applied.float(),
            self.quality_gates_passed.float(),
            self.audio_text_similarity,
            self.boundary_confidence,
            self.segment_emotion_consistency,
            self.previous_segment_confidence,
            self.emotion_transition_probability,
        ], dim=-1)


def default_confidence_features(B: int, device: Device = None) -> ConfidenceFeatures:
    """Neutral defaults for missing upstream signals, on the card unless
    `device` says otherwise."""
    dev = resolve_device(device)
    ones = torch.ones(B, device=dev)
    zeros = torch.zeros(B, device=dev)
    return ConfidenceFeatures(
        snr_db=20.0 * ones, speech_prob=ones, clipping_percent=zeros,
        denoise_gain_db=zeros, asr_conf_segment=ones, lid_entropy=zeros,
        text_reliability_score=ones, conditioning_applied=zeros,
        quality_gates_passed=ones, audio_text_similarity=0.5 * ones,
        boundary_confidence=ones, segment_emotion_consistency=ones,
        previous_segment_confidence=0.5 * ones,
        emotion_transition_probability=0.5 * ones)


# ------------------------------------------------------- dynamic gating MLP

def _init_gating(init: layers.Init, confidence_dim: int, hidden_dim: int) -> dict:
    p = {
        "l1": layers.init_linear(init, confidence_dim, hidden_dim),
        "l2": layers.init_linear(init, hidden_dim, hidden_dim // 2),
        "l3": layers.init_linear(init, hidden_dim // 2, 2),
    }
    # the output layer starts at zero: equal weights after the softmax
    p["l3"] = {k: init.zeros(v.shape) for k, v in p["l3"].items()}
    return p


def init_dynamic_gating(confidence_dim: int = CONFIDENCE_DIM, hidden_dim: int = 32, *,
                        generator: Optional[torch.Generator] = None,
                        device: Device = None) -> dict:
    """The gating MLP's parameters (`generator` on `device`; None seeds one
    with 0), the card unless `device` says otherwise."""
    dev = resolve_device(device)
    return _init_gating(layers.Init(generator, dev), confidence_dim, hidden_dim)


def dynamic_gating(params: dict, conf: Tensor, *, dropout_rate: float = 0.1,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = True):
    """[B, 14] -> (audio_weight [B, 1], text_weight [B, 1]) summing to 1."""
    x = torch.relu(layers.linear(params["l1"], conf))
    x = layers.dropout(generator, x, dropout_rate, deterministic)
    x = torch.relu(layers.linear(params["l2"], x))
    x = layers.dropout(generator, x, dropout_rate, deterministic)
    w = torch.softmax(layers.linear(params["l3"], x), dim=-1)
    return w[:, 0:1], w[:, 1:2]


# ----------------------------------------------------------- policy clamps

def policy_clamps(audio_w: Tensor, text_w: Tensor, feats: ConfidenceFeatures):
    """The five rules, vectorised; weights [B, 1], features [B]."""
    snr = feats.snr_db[:, None]
    asr = feats.asr_conf_segment[:, None]
    ent = feats.lid_entropy[:, None]
    speech = feats.speech_prob[:, None]

    # 1: SNR < 10 dB -> audio <= 0.3, text = 1 - audio
    low_snr = snr < SNR_LOW
    audio_w = torch.where(low_snr, audio_w.clamp(max=0.3), audio_w)
    text_w = torch.where(low_snr, 1.0 - audio_w, text_w)

    # 2: ASR conf < 0.5 -> text <= 0.4, audio = 1 - text
    low_asr = asr < ASR_CONF_LOW
    text_w = torch.where(low_asr, text_w.clamp(max=0.4), text_w)
    audio_w = torch.where(low_asr, 1.0 - text_w, audio_w)

    # 3: LID entropy > 1.5 -> both x 0.7, then renormalised
    high_ent = ent > LID_ENTROPY_HIGH
    audio_w = torch.where(high_ent, audio_w * 0.7, audio_w)
    text_w = torch.where(high_ent, text_w * 0.7, text_w)
    tot = audio_w + text_w
    audio_w = torch.where(high_ent, audio_w / tot, audio_w)
    text_w = torch.where(high_ent, text_w / tot, text_w)

    # 4: speech prob < 0.7 -> audio <= 0.2, text = 1 - audio
    low_speech = speech < SPEECH_PROB_LOW
    audio_w = torch.where(low_speech, audio_w.clamp(max=0.2), audio_w)
    text_w = torch.where(low_speech, 1.0 - audio_w, text_w)

    # 5: both unreliable -> 0.5 / 0.5
    both = ((snr < 5.0) & (speech < 0.5)) & ((asr < 0.3) & (ent > 2.0))
    audio_w = torch.where(both, 0.5, audio_w)
    text_w = torch.where(both, 0.5, text_w)

    tot = audio_w + text_w
    return audio_w / tot, text_w / tot


# --------------------------------------------------- adaptive fusion layer

def _init_proj(init: layers.Init, in_dim: int, out_dim: int) -> dict:
    return {"l1": layers.init_linear(init, in_dim, out_dim),
            "ln": layers.init_layer_norm(init, out_dim),
            "l2": layers.init_linear(init, out_dim, out_dim)}


def _proj(p: dict, x: Tensor, *, rate: float, generator, deterministic: bool) -> Tensor:
    x = torch.relu(layers.linear(p["l1"], x))
    x = layers.dropout(generator, x, rate, deterministic)
    x = layers.layer_norm(p["ln"], x)
    return layers.linear(p["l2"], x)


def init_adaptive_fusion(audio_dim: int, text_dim: int, proj_dim: int = 256, *,
                         generator: Optional[torch.Generator] = None,
                         device: Device = None) -> dict:
    """The fusion layer's parameters, with the JAX module's tree and init
    distributions (`generator` on `device`; None seeds one with 0), the
    card unless `device` says otherwise."""
    init = layers.Init(generator, resolve_device(device))
    return {
        "audio_proj": _init_proj(init, audio_dim, proj_dim),
        "text_proj": _init_proj(init, text_dim, proj_dim),
        "gating": _init_gating(init, CONFIDENCE_DIM, 32),
        "conf_proj": {"l1": layers.init_linear(init, CONFIDENCE_DIM, 32),
                      "l2": layers.init_linear(init, 32, proj_dim // 4)},
        "fusion": _init_proj(init, proj_dim + proj_dim // 4, proj_dim),
        "conf_head": {"l1": layers.init_linear(init, proj_dim, 64),
                      "l2": layers.init_linear(init, 64, 1)},
    }


def adaptive_fusion(params: dict, audio_vec: Tensor, text_vec: Tensor,
                    feats: ConfidenceFeatures, *, dropout_rate: float = 0.1,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True):
    """(fused [B, proj], fusion_confidence [B, 1], info dict)."""
    kw = dict(rate=dropout_rate, generator=generator, deterministic=deterministic)
    ap = _proj(params["audio_proj"], audio_vec, **kw)
    tp = _proj(params["text_proj"], text_vec, **kw)

    conf = feats.to_array()
    aw, tw = dynamic_gating(params["gating"], conf, dropout_rate=dropout_rate,
                            generator=generator, deterministic=deterministic)
    aw, tw = policy_clamps(aw, tw, feats)

    weighted = aw * ap + tw * tp
    cp = torch.relu(layers.linear(params["conf_proj"]["l1"], conf))
    cp = layers.dropout(generator, cp, dropout_rate, deterministic)
    cp = layers.linear(params["conf_proj"]["l2"], cp)

    fused = _proj(params["fusion"], torch.cat([weighted, cp], dim=-1), **kw)
    h = torch.relu(layers.linear(params["conf_head"]["l1"], fused))
    fusion_conf = torch.sigmoid(layers.linear(params["conf_head"]["l2"], h))
    return fused, fusion_conf, {"audio_weight": aw, "text_weight": tw}
