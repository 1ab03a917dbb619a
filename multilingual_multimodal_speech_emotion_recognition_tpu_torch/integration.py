"""Staged data-flow orchestration with per-stage metrics, and streaming.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
integration.py: segmentation -> language ID -> tokenization -> the eval
forward (gates, conditioning, encoders, cross-attention, pooling, fusion,
classifier with OpenMax) -> energy OOD score, with the wall clock of each
stage in ProcessingMetrics; `StreamingRecognizer` runs fixed-length
segments of a stream through the forward and the temporal module
(research/temporal.py); `verify_integration` checks the parameter tree and
the API.

The forward runs under torch.inference_mode() on the device the
parameters live on; on the card its residual stack launches kernel A1. The
per-stage clock separates the host's stages from the forward, whose
internal boundaries it does not see.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .data.tokenizer import Tokenizer, get_tokenizer
from .frontend import lid as lid_mod
from .models import model as mdl
from .research import dual_gate_ood as dg
from .research import temporal as tm


@dataclasses.dataclass
class ProcessingMetrics:
    """Per-stage timing and metadata."""
    stage_name: str
    processing_time: float
    success: bool = True
    metadata: Dict = dataclasses.field(default_factory=dict)


def segment_waveform(wave: np.ndarray, sr: int = 16000, *, segment_seconds: float = 4.0,
                     overlap: float = 0.5) -> List[np.ndarray]:
    """Sliding-window segmentation of long audio (stage 1), feeding the
    temporal module's 3-segment buffer."""
    seg = int(segment_seconds * sr)
    hop = max(int(seg * (1.0 - overlap)), 1)
    if len(wave) <= seg:
        return [wave]
    out = []
    for start in range(0, len(wave) - seg + 1, hop):
        out.append(wave[start:start + seg])
    if (len(wave) - seg) % hop:
        out.append(wave[-seg:])
    return out


def _device(params: dict) -> torch.device:
    return params["classifier"]["input_proj"]["kernel"].device


class DataFlowPipeline:
    """End-to-end staged processing over the port's components."""

    def __init__(self, params: dict, cfg: Config, tokenizer: Optional[Tokenizer] = None):
        self.params = params
        self.cfg = cfg
        self.device = _device(params)
        self.tokenizer = tokenizer or get_tokenizer(vocab_size=cfg.model.text.vocab_size)
        self._metrics: List[ProcessingMetrics] = []

    @torch.inference_mode()
    def _fwd(self, batch: dict):
        out = mdl.model_forward(self.params, self.cfg.model, batch, deterministic=True,
                                use_openmax=True)
        return out.logits, out.uncertainty, out.features

    def _record(self, name: str, t0: float, **meta) -> None:
        self._metrics.append(ProcessingMetrics(
            stage_name=name, processing_time=time.perf_counter() - t0, metadata=meta))

    def process_audio_segment(self, audio: np.ndarray, text: str = "", *,
                              sr: int = 16000) -> Dict:
        """One segment through the whole flow: predictions and stage metrics."""
        self._metrics = []

        # stage 1: segmentation bookkeeping (one segment here)
        t0 = time.perf_counter()
        max_t = int(self.cfg.data.max_audio_seconds * sr)
        audio = np.asarray(audio, np.float32)[:max_t]
        self._record("segmentation", t0, samples=len(audio))

        # stage 2: language ID (host, the text side of the gates)
        t0 = time.perf_counter()
        ent, lang, conf = lid_mod.identify_language(text)
        self._record("language_id", t0, language=lang, entropy=ent)

        # stage 3: tokenize (host)
        t0 = time.perf_counter()
        ids, tmask = self.tokenizer.encode_batch([text], self.cfg.data.max_text_tokens)
        self._record("tokenize", t0, tokens=int(tmask.sum()))

        # stages 4-12 in one forward on the device: gates -> conditioning ->
        # encoders -> cross-attention -> pooling -> fusion -> classifier
        t0 = time.perf_counter()
        wave = torch.from_numpy(audio)[None, :].to(self.device)
        batch = {
            "audio": wave,
            "audio_mask": torch.ones_like(wave),
            "text_ids": torch.from_numpy(np.asarray(ids)).to(self.device),
            "text_mask": torch.from_numpy(np.asarray(tmask, np.float32)).to(self.device),
            "lid_entropy": torch.tensor([ent], dtype=torch.float32, device=self.device),
            "lid_conf": torch.tensor([conf], dtype=torch.float32, device=self.device),
        }
        logits, uncertainty, features = self._fwd(batch)
        logits = logits.double().cpu().numpy()
        uncertainty = uncertainty.cpu().numpy()
        self._record("fused_model_forward", t0)

        # stage 12b: the late OOD signal (energy score of the logits, f32)
        t0 = time.perf_counter()
        energy = float(-torch.logsumexp(torch.from_numpy(logits[0]).float(), dim=0))
        self._record("ood_energy", t0, energy=energy)

        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        return {
            "logits": logits[0],
            "probabilities": probs[0],
            "prediction": int(logits[0].argmax()),
            "uncertainty": float(uncertainty[0, 0]),
            "energy_score": energy,
            "language": lang,
            "stage_metrics": list(self._metrics),
            "total_time": sum(m.processing_time for m in self._metrics),
        }

    def process_long_audio(self, audio: np.ndarray, text: str = "", *, sr: int = 16000,
                           segment_seconds: float = 4.0) -> List[Dict]:
        """Segment long audio and run each window through every stage."""
        return [self.process_audio_segment(seg, text, sr=sr)
                for seg in segment_waveform(audio, sr, segment_seconds=segment_seconds)]


class StreamingRecognizer:
    """Chunked recognition with temporal smoothing.

    Audio arrives in chunks of any size; every full `segment_seconds`
    window runs one forward (one fixed segment shape for the whole stream)
    giving the classifier's penultimate features, then the temporal step
    (buffer push -> positional encoding -> causal TCN over the 3-segment
    window -> confidence smoothing -> speaker change) carries its
    `TemporalBufferState` from segment to segment.

    `temporal_params` defaults to a fresh init from `seed` on the
    parameters' device. `push_audio` returns one result per completed
    segment; `flush` runs the tail (zero-padded, masked)."""

    def __init__(self, params: dict, cfg: Config, *, temporal_params: Optional[dict] = None,
                 segment_seconds: float = 4.0, sr: int = 16000,
                 tokenizer: Optional[Tokenizer] = None, seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.sr = sr
        self.device = _device(params)
        self.segment_len = int(segment_seconds * sr)
        self.tokenizer = tokenizer or get_tokenizer(vocab_size=cfg.model.text.vocab_size)
        self.feature_dim = cfg.model.classifier_base_dim // 2
        self.temporal_params = temporal_params or tm.init_temporal_module(
            self.feature_dim, cfg.model.num_labels,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        self.reset()

    @torch.inference_mode()
    def _fwd(self, batch: dict):
        out = mdl.model_forward(self.params, self.cfg.model, batch, deterministic=True,
                                use_openmax=True)
        probs = torch.softmax(out.logits.float(), dim=-1)
        return (out.logits, out.uncertainty, out.features.float(),
                probs.amax(dim=-1, keepdim=True))

    def reset(self) -> None:
        self.state = tm.init_buffer(1, self.feature_dim, device=self.device)
        self._pending = np.zeros(0, np.float32)
        self.segment_index = 0

    def push_audio(self, samples: np.ndarray, text: str = "") -> List[Dict]:
        """Feed a chunk of any length; returns the results of the segments
        it completes (maybe none: the state accumulates)."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, np.float32).reshape(-1)])
        out = []
        while len(self._pending) >= self.segment_len:
            seg, self._pending = (self._pending[:self.segment_len],
                                  self._pending[self.segment_len:])
            out.append(self._process(seg, self.segment_len, text))
        return out

    def flush(self, text: str = "") -> Optional[Dict]:
        """Run the tail (< one segment), zero-padded and masked."""
        n = len(self._pending)
        if n == 0:
            return None
        seg = np.zeros(self.segment_len, np.float32)
        seg[:n] = self._pending
        self._pending = np.zeros(0, np.float32)
        return self._process(seg, n, text)

    def _process(self, seg: np.ndarray, valid: int, text: str) -> Dict:
        ent, lang, conf = lid_mod.identify_language(text)
        ids, tmask = self.tokenizer.encode_batch([text], self.cfg.data.max_text_tokens)
        mask = np.zeros_like(seg)
        mask[:max(valid, 1)] = 1.0
        dev = self.device
        batch = {
            "audio": torch.from_numpy(seg)[None].to(dev),
            "audio_mask": torch.from_numpy(mask)[None].to(dev),
            "text_ids": torch.from_numpy(np.asarray(ids)).to(dev),
            "text_mask": torch.from_numpy(np.asarray(tmask, np.float32)).to(dev),
            "lid_entropy": torch.tensor([ent], dtype=torch.float32, device=dev),
            "lid_conf": torch.tensor([conf], dtype=torch.float32, device=dev),
        }
        logits, uncertainty, feats, seg_conf = self._fwd(batch)
        with torch.inference_mode():
            self.state, smoothed, final_conf, info = tm.temporal_step(
                self.temporal_params, self.state, feats, seg_conf)
        smoothed = smoothed.double().cpu().numpy()
        e = np.exp(smoothed - smoothed.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        result = {
            "segment_index": self.segment_index,
            "raw_logits": logits.cpu().numpy()[0],
            "smoothed_logits": smoothed[0],
            "probabilities": probs[0],
            "prediction": int(smoothed[0].argmax()),
            "confidence": float(final_conf[0, 0]),
            "uncertainty": float(uncertainty[0, 0]),
            "speaker_changed": bool(info["speaker_changed"][0]),
            "speaker_similarity": float(info["speaker_similarity"][0]),
            "language": lang,
        }
        self.segment_index += 1
        return result


def verify_integration(params: dict, cfg: Config) -> Dict[str, bool]:
    """Component presence, checked on the parameter tree and the API."""
    checks = {}
    p = params
    checks["audio_encoder"] = "audio_backbone" in p and (
        "convs" in p["audio_backbone"] or cfg.model.audio.is_conformer)
    checks["text_encoder"] = "text_backbone" in p
    checks["adapters"] = "audio_adapter" in p and "text_adapter" in p
    checks["cross_modal_attention"] = "cross" in p
    checks["pooling"] = "pool_a" in p and "pool_t" in p
    checks["fusion"] = "fusion" in p
    checks["classifier"] = ("classifier" in p
                            and "layers" in p["classifier"]
                            and "anchor" in p["classifier"]
                            and "uncertainty" in p["classifier"])
    checks["openmax_weibull"] = "weibull" in p.get("classifier", {})
    checks["prototypes"] = "prototypes" in p
    checks["frontend_feature_fusion"] = any(
        k in p for k in ("combined_fusion", "quality_fusion", "conditioning_fusion"))
    checks["quality_gates_flag"] = isinstance(cfg.model.use_quality_gates, bool)
    checks["dual_gate_ood_available"] = callable(dg.dual_gate_ood)
    checks["all_passed"] = all(v for k, v in checks.items())
    return checks
