"""Language identification for the quality gates (text side, host).

A copy of multilingual_multimodal_speech_emotion_recognition_tpu/frontend/
lid.py: pure host Python, which the port may not import.

The reference uses langdetect plus a SIMULATED 10-language probability
distribution (its src/models/quality_gates.py:249-304): the
detected language gets p=0.7 over a 0.05 base, normalized; unknown
languages get a uniform distribution; empty text returns entropy 1.5,
"unknown", confidence 0. The entropy is therefore one of three constants —
what actually matters downstream is the detected language + that
distribution shape, which we reproduce with a dependency-free detector
(script ranges + stop-word lists, as evaluation/cross_lingual_metrics.py
does on the eval side).
"""

from __future__ import annotations

import math
from typing import List, Tuple

LANGUAGES = ['en', 'es', 'fr', 'de', 'it', 'pt', 'ru', 'ja', 'ko', 'zh']

_STOPWORDS = {
    'en': {'the', 'a', 'an', 'and', 'is', 'are', 'was', 'to', 'of', 'in',
           'it', 'that', 'this', 'for', 'with', 'you', 'not', 'have'},
    'es': {'el', 'la', 'los', 'las', 'un', 'una', 'y', 'es', 'son', 'de',
           'en', 'que', 'no', 'por', 'con', 'para', 'está'},
    'fr': {'le', 'la', 'les', 'un', 'une', 'et', 'est', 'sont', 'de', 'en',
           'que', 'ne', 'pas', 'pour', 'avec', 'dans', 'ce'},
    'de': {'der', 'die', 'das', 'ein', 'eine', 'und', 'ist', 'sind', 'von',
           'zu', 'mit', 'nicht', 'ich', 'du', 'für', 'auf'},
    'it': {'il', 'lo', 'la', 'gli', 'un', 'una', 'e', 'è', 'sono', 'di',
           'che', 'non', 'per', 'con', 'questo'},
    'pt': {'o', 'a', 'os', 'as', 'um', 'uma', 'e', 'é', 'são', 'de', 'em',
           'que', 'não', 'por', 'com', 'para'},
}


def _script_language(text: str) -> str | None:
    """Unicode-script shortcut for non-Latin languages
    (cf. asr_integration.py:239-277 script-based detection; Indic ranges
    added for the zero-shot hi/bn/te evaluation path)."""
    counts = {'ru': 0, 'ja': 0, 'ko': 0, 'zh': 0, 'hi': 0, 'bn': 0, 'te': 0}
    letters = 0
    for ch in text:
        o = ord(ch)
        if ch.isalpha():
            letters += 1
        if 0x0400 <= o <= 0x04FF:
            counts['ru'] += 1
        elif 0x3040 <= o <= 0x30FF:
            counts['ja'] += 1
        elif 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF:
            counts['ko'] += 1
        elif 0x4E00 <= o <= 0x9FFF:
            counts['zh'] += 1
        elif 0x0900 <= o <= 0x097F:
            counts['hi'] += 1   # Devanagari
        elif 0x0980 <= o <= 0x09FF:
            counts['bn'] += 1   # Bengali
        elif 0x0C00 <= o <= 0x0C7F:
            counts['te'] += 1   # Telugu
    if letters == 0:
        return None
    best = max(counts, key=counts.get)
    if counts[best] > 0.3 * letters:
        return best
    return None


def detect_language(text: str) -> str | None:
    """Best-effort language code, None if undecidable."""
    if not text or not text.strip():
        return None
    script = _script_language(text)
    if script:
        return script
    words = {w.strip('.,!?;:"\'').lower() for w in text.split()}
    scores = {lang: len(words & sw) for lang, sw in _STOPWORDS.items()}
    best = max(scores, key=scores.get)
    if scores[best] > 0:
        return best
    # Latin-script default mirrors langdetect's strong prior toward 'en'
    # on the ASCII-only CREMA/RAVDESS/TESS transcripts.
    if all(ord(c) < 128 for c in text):
        return 'en'
    return None


def simulated_distribution(lang: str | None) -> List[float]:
    """The reference's simulated LID distribution (quality_gates.py:276-293)."""
    n = len(LANGUAGES)
    if lang in LANGUAGES:
        probs = [0.05] * n
        probs[LANGUAGES.index(lang)] = 0.7
        s = sum(probs)
        return [p / s for p in probs]
    return [1.0 / n] * n


def identify_language(text: str | None) -> Tuple[float, str, float]:
    """(lid_entropy, dominant_language, dominant_confidence) —
    quality_gates.py:257-304 semantics including the empty-text fallback."""
    if not text or not text.strip():
        return 1.5, "unknown", 0.0
    lang = detect_language(text)
    probs = simulated_distribution(lang)
    entropy = -sum(p * math.log(p + 1e-10) for p in probs)
    dom = max(range(len(probs)), key=lambda i: probs[i])
    return float(entropy), LANGUAGES[dom] if lang else "unknown", float(probs[dom])


def gate_lid(text: str | None) -> Tuple[float, str, float]:
    """LID as the GATE ORCHESTRATOR sees it (quality_gates.py:508-512):
    only non-empty text reaches identify_language; empty/None text takes
    the orchestrator's own fallback (1.0, "unknown", 0.0) — NOT
    identify_language's internal 1.5 empty-text return, which that call
    path never produces."""
    if text and text.strip():
        return identify_language(text)
    return 1.0, "unknown", 0.0


def batch_lid(texts) -> Tuple[List[float], List[str], List[float]]:
    """Per-utterance gate-level LID scalars for batch assembly
    (data/pipeline.py) — gate-orchestration semantics, see gate_lid."""
    ents, langs, confs = [], [], []
    for t in texts:
        e, l, c = gate_lid(t)
        ents.append(e)
        langs.append(l)
        confs.append(c)
    return ents, langs, confs
