"""ASR integration: Whisper transcription, word-level confidences,
script-based code-switch detection, timestamp alignment, confidence-
weighted attention masks and the 8-dim ASR features.

A copy of multilingual_multimodal_speech_emotion_recognition_tpu/frontend/
asr.py (pure host Python, which the port may not import), after the
reference's src/models/asr_integration.py:
  * the ASRResult container (:30-58)
  * Whisper with per-token scores -> word confidences grouped at space
    boundaries (:59-237); the integration degrades to an empty result when
    no backend is available (the reference's fallback chain, :74-81)
  * script-based language and code-switch detection by Unicode ranges
    (:239-277)
  * isotonic-regression confidence calibration (:279-293)
  * the simplified alignment: uniform word timestamps, per-character
    phones, RMS-threshold silence regions (:296-462)
  * the confidence mask: conf < 0.3 -> 0, < 0.6 -> 0.3, else 1;
    text_reliability = mean word confidence (:465-514)
  * the 8-dim ASR feature vector (:584-600); its learned 8 -> 32 -> 8
    projection lives in the model's tree (models/model.py `asr_proj`,
    applied in encode_text before the asr_fusion block)

Two backends: `TorchWhisperASR` runs the port's Whisper (models/
whisper.py) on the card, the counterpart of the JAX package's
JaxWhisperASR; `WhisperASR` loads a pretrained model through transformers
on the host and reports itself unavailable where it cannot (no package, no
weights, no network).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

SCRIPT_RANGES = {
    "cyrillic": (0x0400, 0x04FF, "ru"),
    "cjk": (0x4E00, 0x9FFF, "zh"),
    "hiragana_katakana": (0x3040, 0x30FF, "ja"),
    "hangul": (0xAC00, 0xD7AF, "ko"),
    "arabic": (0x0600, 0x06FF, "ar"),
    "devanagari": (0x0900, 0x097F, "hi"),
    "bengali": (0x0980, 0x09FF, "bn"),
    "telugu": (0x0C00, 0x0C7F, "te"),
}


@dataclasses.dataclass
class ASRResult:
    text: str = ""
    language: str = "unknown"
    detected_languages: List[str] = dataclasses.field(default_factory=list)
    word_confidences: List[float] = dataclasses.field(default_factory=list)
    segment_confidence: float = 0.0
    overall_confidence: float = 0.0
    word_timestamps: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    phone_alignment: List[Dict] = dataclasses.field(default_factory=list)
    silence_regions: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    code_switches: List[Dict] = dataclasses.field(default_factory=list)
    language_segments: List[Dict] = dataclasses.field(default_factory=list)
    text_reliability_score: float = 0.0
    attention_mask_weighted: Optional[np.ndarray] = None
    asr_features: Optional[np.ndarray] = None


# --------------------------------------------------- script-based detection

def detect_scripts(text: str) -> List[str]:
    """Languages present by Unicode script (asr_integration.py:239-260).
    Latin text maps to 'en' (the reference's default)."""
    langs = []
    if re.search(r"[A-Za-z]", text):
        langs.append("en")
    for lo, hi, lang in SCRIPT_RANGES.values():
        if any(lo <= ord(c) <= hi for c in text):
            if lang not in langs:
                langs.append(lang)
    return langs or ["unknown"]


def detect_code_switches(text: str) -> List[Dict]:
    """Word-boundary language switches (asr_integration.py:262-277)."""
    def word_lang(w: str) -> str:
        for lo, hi, lang in SCRIPT_RANGES.values():
            if any(lo <= ord(c) <= hi for c in w):
                return lang
        return "en" if re.search(r"[A-Za-z]", w) else "unknown"

    switches = []
    prev = None
    for i, w in enumerate(text.split()):
        lang = word_lang(w)
        if prev is not None and lang != prev and "unknown" not in (lang, prev):
            switches.append({"position": i, "from_language": prev,
                             "to_language": lang, "word": w})
        prev = lang
    return switches


# ------------------------------------------------------- confidence masking

VERY_LOW_CONF = 0.3
LOW_CONF = 0.6


def confidence_weighted_mask(word_confidences: List[float]) -> np.ndarray:
    """conf < 0.3 -> 0.0, < 0.6 -> 0.3, else 1.0 (asr_integration.py:497-514)."""
    if not word_confidences:
        return np.ones(1, np.float32)
    conf = np.asarray(word_confidences, np.float32)
    return np.where(conf < VERY_LOW_CONF, 0.0,
                    np.where(conf < LOW_CONF, 0.3, 1.0)).astype(np.float32)


def group_token_confidences_to_words(tokens: List[str],
                                     token_confidences: List[float]) -> List[float]:
    """Max-prob tokens grouped into words at space boundaries
    (asr_integration.py:205-237): a word's confidence is the mean of its
    tokens' confidences."""
    words, cur = [], []
    for tok, conf in zip(tokens, token_confidences):
        if (tok.startswith(" ") or tok.startswith("▁")) and cur:
            words.append(float(np.mean(cur)))
            cur = []
        cur.append(conf)
    if cur:
        words.append(float(np.mean(cur)))
    return words


class ConfidenceCalibrator:
    """Isotonic-regression calibration (asr_integration.py:279-293);
    scikit-learn is imported by `fit` only."""

    def __init__(self):
        self._iso = None

    def fit(self, confidences: np.ndarray, correct: np.ndarray) -> None:
        from sklearn.isotonic import IsotonicRegression
        self._iso = IsotonicRegression(out_of_bounds="clip")
        self._iso.fit(np.asarray(confidences), np.asarray(correct))

    def calibrate(self, confidences: np.ndarray) -> np.ndarray:
        if self._iso is None:
            return np.asarray(confidences)
        return self._iso.predict(np.asarray(confidences))


# --------------------------------------------------------------- alignment

def uniform_word_timestamps(text: str, duration: float) -> List[Tuple[float, float]]:
    """The reference's simplified alignment: words spread uniformly over
    the clip (asr_integration.py:341-365)."""
    words = text.split()
    if not words:
        return []
    per = duration / len(words)
    return [(i * per, (i + 1) * per) for i in range(len(words))]


def char_phone_alignment(text: str,
                         word_timestamps: List[Tuple[float, float]]) -> List[Dict]:
    """Per-character 'phones' within each word's span (:367-400)."""
    out = []
    for word, (start, end) in zip(text.split(), word_timestamps):
        if not word:
            continue
        per = (end - start) / len(word)
        for i, ch in enumerate(word):
            out.append({"phone": ch, "start": start + i * per,
                        "end": start + (i + 1) * per, "word": word})
    return out


def silence_regions_rms(audio: np.ndarray, sr: int = 16000, *,
                        frame_ms: float = 25.0, hop_ms: float = 10.0,
                        threshold_ratio: float = 0.1,
                        min_duration: float = 0.1) -> List[Tuple[float, float]]:
    """RMS-threshold silence spans (:402-438)."""
    frame = int(sr * frame_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    if len(audio) < frame:
        return []
    n = 1 + (len(audio) - frame) // hop
    rms = np.asarray([np.sqrt((audio[i * hop:i * hop + frame] ** 2).mean())
                      for i in range(n)])
    thr = threshold_ratio * (rms.max() + 1e-12)
    silent = rms < thr
    regions, start = [], None
    for i, s in enumerate(silent):
        t = i * hop / sr
        if s and start is None:
            start = t
        elif not s and start is not None:
            if t - start >= min_duration:
                regions.append((start, t))
            start = None
    if start is not None:
        end = n * hop / sr
        if end - start >= min_duration:
            regions.append((start, end))
    return regions


# ----------------------------------------------------------------- backends

class TorchWhisperASR:
    """The port's Whisper as an ASR backend: log-mel, encoder and the
    KV-cached greedy decode (models/whisper.py) on the card unless the
    caller passes device="cpu". Duck-types WhisperASR's backend protocol
    (.available / .transcribe), so EnhancedASRIntegration takes it as it
    is.

    Built from the port's Whisper parameters (plus an optional HF tokenizer
    for id -> text; without one the text is the space-joined raw ids, which
    the confidence pipeline treats as words). int8=True quantises the
    encoder and decoder layer stacks (ops/quant.quantize_whisper)."""

    def __init__(self, params: dict, cfg, *, tokenizer=None, prefix_ids=None,
                 max_new_tokens: int = 48, int8: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        from ..ops import quant
        from ..utils.runtime import resolve_device, tree_to
        self.device = resolve_device(device)
        params = tree_to(params, self.device)
        if int8:
            # greedy decode re-reads the whole decoder per token: int8
            # halves those weight bytes
            params = quant.quantize_whisper(params)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prefix_ids = (list(prefix_ids) if prefix_ids is not None
                           else [cfg.decoder_start_token_id])
        self.max_new_tokens = max_new_tokens

    @classmethod
    def from_hf_model(cls, model, **kw) -> "TorchWhisperASR":
        """Convert a transformers WhisperForConditionalGeneration."""
        from ..models import whisper as tw
        c = model.config
        cfg = tw.WhisperConfig(
            vocab_size=c.vocab_size, num_mel_bins=c.num_mel_bins,
            d_model=c.d_model, encoder_layers=c.encoder_layers,
            encoder_attention_heads=c.encoder_attention_heads,
            decoder_layers=c.decoder_layers,
            decoder_attention_heads=c.decoder_attention_heads,
            encoder_ffn_dim=c.encoder_ffn_dim, decoder_ffn_dim=c.decoder_ffn_dim,
            max_source_positions=c.max_source_positions,
            max_target_positions=c.max_target_positions,
            decoder_start_token_id=c.decoder_start_token_id,
            eos_token_id=c.eos_token_id)
        return cls(tw.params_from_hf(model.state_dict(), cfg), cfg, **kw)

    @property
    def available(self) -> bool:
        return True

    @torch.inference_mode()
    def transcribe(self, audio: np.ndarray, sr: int = 16000
                   ) -> Tuple[str, List[str], List[float]]:
        from ..models import whisper as tw
        wave = torch.from_numpy(np.array(audio, np.float32)[None]).to(self.device)
        prefix = torch.tensor([self.prefix_ids], dtype=torch.int32, device=self.device)
        toks, confs = tw.transcribe_batch(self.params, self.cfg, wave, prefix,
                                          max_new_tokens=self.max_new_tokens)
        ids = [int(t) for t in toks[0].cpu()]
        cf = [float(c) for c in confs[0].cpu()]
        # trim at EOS (the step that emitted it is kept, the frozen tail cut)
        if self.cfg.eos_token_id in ids:
            n = ids.index(self.cfg.eos_token_id) + 1
            ids, cf = ids[:n], cf[:n]
        if self.tokenizer is not None:
            tokens = [self.tokenizer.decode([i]) for i in ids]
            text = self.tokenizer.decode(ids, skip_special_tokens=True)
        else:
            tokens = [str(i) for i in ids]
            text = " ".join(tokens)
        return text, tokens, cf


class WhisperASR:
    """Lazy Whisper backend (transformers, on the host). Loads on first use;
    reports availability instead of raising when the package or the weights
    are absent (the reference's try/fallback chain, asr_integration.py:74-81)."""

    def __init__(self, model_name: str = "openai/whisper-base"):
        self.model_name = model_name
        self._model = None
        self._processor = None
        self._failed = False

    @property
    def available(self) -> bool:
        if self._failed:
            return False
        if self._model is not None:
            return True
        try:
            from transformers import WhisperForConditionalGeneration, WhisperProcessor
            self._processor = WhisperProcessor.from_pretrained(self.model_name)
            self._model = WhisperForConditionalGeneration.from_pretrained(self.model_name)
            return True
        except Exception:
            # no transformers, no weights or no network: the integration
            # falls back to the empty result, as the reference's does
            self._failed = True
            return False

    def transcribe(self, audio: np.ndarray, sr: int = 16000
                   ) -> Tuple[str, List[str], List[float]]:
        """(text, tokens, token_confidences) with output_scores=True
        (asr_integration.py:150-204)."""
        inputs = self._processor(audio, sampling_rate=sr, return_tensors="pt")
        with torch.no_grad():
            out = self._model.generate(inputs.input_features, output_scores=True,
                                       return_dict_in_generate=True, max_new_tokens=128)
        ids = out.sequences[0]
        text = self._processor.decode(ids, skip_special_tokens=True)
        tokens, confs = [], []
        gen_ids = ids[-len(out.scores):]
        for tok_id, score in zip(gen_ids, out.scores):
            probs = torch.softmax(score[0], dim=-1)
            tokens.append(self._processor.decode([tok_id]))
            confs.append(float(probs.max()))
        return text, tokens, confs


class EnhancedASRIntegration:
    """Orchestrates transcription -> confidence -> alignment -> features
    (asr_integration.py:517-630). With no usable backend it degrades to the
    reference's empty-result path."""

    def __init__(self, backend=None, calibrator: Optional[ConfidenceCalibrator] = None):
        self.backend = backend or WhisperASR()
        self.calibrator = calibrator or ConfidenceCalibrator()

    def process(self, audio: np.ndarray, sr: int = 16000,
                text: Optional[str] = None) -> ASRResult:
        duration = len(audio) / sr
        if text is None:
            if self.backend.available:
                text, tokens, token_confs = self.backend.transcribe(audio, sr)
                word_confs = group_token_confidences_to_words(tokens, token_confs)
                word_confs = list(self.calibrator.calibrate(
                    np.asarray(word_confs))) if word_confs else []
            else:
                text, word_confs = "", []
        else:
            word_confs = [1.0] * len(text.split())

        langs = detect_scripts(text) if text else ["unknown"]
        switches = detect_code_switches(text) if text else []
        timestamps = uniform_word_timestamps(text, duration)
        phones = char_phone_alignment(text, timestamps)
        silences = silence_regions_rms(audio, sr)

        overall = float(np.mean(word_confs)) if word_confs else 0.0
        result = ASRResult(
            text=text, language=langs[0], detected_languages=langs,
            word_confidences=word_confs, segment_confidence=overall,
            overall_confidence=overall, word_timestamps=timestamps,
            phone_alignment=phones, silence_regions=silences,
            code_switches=switches,
            language_segments=[{"language": lang} for lang in langs],
            text_reliability_score=overall,
            attention_mask_weighted=confidence_weighted_mask(word_confs))
        result.asr_features = self.features(result)
        return result

    @staticmethod
    def features(r: ASRResult) -> np.ndarray:
        """Raw 8-dim ASR feature vector (asr_integration.py:584-600)."""
        mean_dur = (float(np.mean([e - s for s, e in r.word_timestamps]))
                    if r.word_timestamps else 0.0)
        return np.asarray([
            r.overall_confidence,
            r.text_reliability_score,
            len(r.detected_languages) / 5.0,
            len(r.code_switches) / 10.0,
            len(r.silence_regions) / 20.0,
            mean_dur,
            len(r.text.split()) / 50.0,
            float(len(r.text) > 0),
        ], np.float32)


def create_enhanced_asr(**kw) -> EnhancedASRIntegration:
    """Factory (the reference's asr_integration_fixed.py compatibility shim)."""
    return EnhancedASRIntegration(**kw)
