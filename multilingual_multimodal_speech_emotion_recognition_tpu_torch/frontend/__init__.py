"""Signal-processing front-end: quality gates, conditioning, language ID,
ASR integration.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
frontend/__init__.py.
`frontend_process` chains gates then conditioning, as the reference's audio
encoder does, on the device of the wave it is given.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import asr, conditioning, lid, quality_gates, spectral
from .asr import ASRResult, EnhancedASRIntegration, create_enhanced_asr
from .conditioning import (NOISE_TYPES, ConditioningStats, condition_audio,
                           conditioning_report, detect_noise_type)
from .lid import batch_lid, identify_language
from .quality_gates import QualityStats, quality_gates as run_quality_gates

__all__ = [
    "ASRResult", "ConditioningStats", "EnhancedASRIntegration",
    "NOISE_TYPES", "QualityStats", "asr", "batch_lid", "condition_audio",
    "conditioning", "conditioning_report", "create_enhanced_asr",
    "detect_noise_type", "frontend_process", "identify_language", "lid",
    "quality_gates", "run_quality_gates", "spectral",
]


def frontend_process(wave: torch.Tensor, mask: torch.Tensor, *,
                     lid_entropy: torch.Tensor, lid_confidence: torch.Tensor,
                     sample_rate: int = 16000, use_gates: bool = True,
                     use_conditioning: bool = True, zero_non_accept: bool = False):
    """Gates then conditioning. Returns (processed_wave, quality_feats
    [B, 8], cond_feats [B, 12], stats dict); a stage that is off leaves
    zeros for its features. zero_non_accept zeroes non-'accept' clips
    before conditioning, as the reference encoder does."""
    B = wave.shape[0]
    q_feats = wave.new_zeros((B, 8))
    c_feats = wave.new_zeros((B, 12))
    stats = {}
    if use_gates:
        with profiling.span("dsp.gates"):
            wave, q = run_quality_gates(wave, mask, lid_entropy=lid_entropy,
                                        lid_confidence=lid_confidence,
                                        sample_rate=sample_rate,
                                        zero_non_accept=zero_non_accept)
        q_feats, stats["quality"] = q.features, q
    if use_conditioning:
        with profiling.span("dsp.conditioning"):
            wave, c = condition_audio(wave, mask, sample_rate=sample_rate)
        c_feats, stats["conditioning"] = c.features, c
    return wave, q_feats, c_feats, stats
