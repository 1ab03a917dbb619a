"""Zero-shot cross-lingual evaluation: Hindi / Bengali / Telugu.

A copy of the JAX package's eval/zero_shot.py (plain numpy / Python).

The reference evaluates cross-lingual transfer on SIMULATED multilingual
texts (the reference's src/evaluate_academic_complete.py:185 — it maps
manifest texts to stand-in translations before slicing with
evaluation/cross_lingual_metrics.py:130-172). This module is the same
recipe made explicit and hermetic (zero-egress): each English manifest
text is rendered into the target language with a native-script word table
(unmapped words transliterate by passing through), the audio is unchanged,
and the trained (English-text) model is evaluated per language. Per-language
slices and transfer ratios vs the English baseline come from
eval/slicing.py.

Native script matters: the LID front-end and the per-language slicer key
off Unicode script ranges (frontend/lid.py), so romanized stand-ins (the
code-mixing tables in eval/robustness.py) would all be tagged Latin/'en'.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from . import slicing

# Small native-script equivalence tables for the function words and
# emotion vocabulary that appear in CREMA/RAVDESS/TESS-style transcripts.
# These are stand-in translations (like the reference's simulated texts),
# not an MT system.
HINDI_TABLE = {
    'the': 'यह', 'is': 'है', 'and': 'और', 'in': 'में', 'to': 'को',
    'of': 'का', 'a': 'एक', 'that': 'वह', 'it': 'यह', 'with': 'साथ',
    'for': 'लिए', 'on': 'पर', 'from': 'से', 'good': 'अच्छा',
    'bad': 'बुरा', 'audio': 'ऑडियो', 'sample': 'नमूना',
    'dataset': 'डेटासेट', 'words': 'शब्द', 'angry': 'गुस्सा',
    'happy': 'खुश', 'sad': 'उदास', 'neutral': 'तटस्थ',
    'fear': 'डर', 'disgust': 'घृणा',
}
BENGALI_TABLE = {
    'the': 'এই', 'is': 'হয়', 'and': 'এবং', 'in': 'মধ্যে', 'to': 'কে',
    'of': 'এর', 'a': 'একটা', 'that': 'ওই', 'it': 'এটা', 'with': 'সাথে',
    'for': 'জন্য', 'on': 'উপর', 'from': 'থেকে', 'good': 'ভাল',
    'bad': 'খারাপ', 'audio': 'অডিও', 'sample': 'নমুনা',
    'dataset': 'ডেটাসেট', 'words': 'শব্দ', 'angry': 'রাগান্বিত',
    'happy': 'খুশি', 'sad': 'দুঃখিত', 'neutral': 'নিরপেক্ষ',
    'fear': 'ভয়', 'disgust': 'ঘৃণা',
}
TELUGU_TABLE = {
    'the': 'ఈ', 'is': 'ఉంది', 'and': 'మరియు', 'in': 'లో', 'to': 'కు',
    'of': 'యొక్క', 'a': 'ఒక', 'that': 'ఆ', 'it': 'ఇది', 'with': 'తో',
    'for': 'కోసం', 'on': 'మీద', 'from': 'నుండి', 'good': 'మంచి',
    'bad': 'చెడు', 'audio': 'ఆడియో', 'sample': 'నమూనా',
    'dataset': 'డేటాసెట్', 'words': 'పదాలు', 'angry': 'కోపం',
    'happy': 'సంతోషం', 'sad': 'విచారం', 'neutral': 'తటస్థ',
    'fear': 'భయం', 'disgust': 'అసహ్యం',
}
TABLES: Dict[str, Dict[str, str]] = {
    'hi': HINDI_TABLE, 'bn': BENGALI_TABLE, 'te': TELUGU_TABLE,
}


def translate_text(text: str, language: str) -> str:
    """Word-table rendering into the target language's native script;
    unmapped words pass through (mirrors the reference's simulated-text
    approach rather than pretending to be MT)."""
    table = TABLES[language]
    return " ".join(table.get(w.strip('.,!?;:"\'').lower(), w)
                    for w in text.split())


def evaluate_zero_shot(
        predict_fn: Callable[[List[str]], Dict],
        texts: List[str], labels: np.ndarray, confidences: np.ndarray,
        preds_source: np.ndarray, *,
        languages: Sequence[str] = ('hi', 'bn', 'te'),
        source_language: str = 'en') -> Dict:
    """Zero-shot sweep: `predict_fn(translated_texts)` must return
    {"preds", "probs"} over the same (audio, label) pairs. Returns the
    per-language slice table + transfer ratios vs the source baseline
    (cross_lingual_metrics.py:130-172 semantics)."""
    labels = np.asarray(labels)
    per_language = {source_language: slicing._slice_metrics(
        f"Language_{source_language}", labels, np.asarray(preds_source),
        np.asarray(confidences))}
    for lang in languages:
        translated = [translate_text(t, lang) for t in texts]
        out = predict_fn(translated)
        preds = np.asarray(out["preds"])
        probs = np.asarray(out["probs"])
        conf = probs.max(axis=1) if probs.ndim == 2 and len(probs) else \
            np.zeros(len(preds))
        per_language[lang] = slicing._slice_metrics(
            f"Language_{lang}", labels, preds, conf)
    return {
        "per_language": {k: vars(v) for k, v in per_language.items()},
        "transfer": slicing.transfer_ratios(per_language, source_language),
    }
