"""Performance slicing: per-language and per-SNR-band analysis, plus
cross-lingual transfer ratios.

A copy of the JAX package's eval/slicing.py (plain numpy / Python).

Parity with the reference's src/evaluation/enhanced_evaluation.py:369-489
(language and SNR slices over {accuracy, weighted F1, macro F1, per-class
F1}; default SNR bands (−inf,5)(5,10)(10,15)(15,20)(20,inf) from :564) and
cross_lingual_metrics.py:130-172 (transfer ratio = F1_target / F1_source,
overall = mean over targets).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import metrics as M

DEFAULT_SNR_BANDS: List[Tuple[float, float]] = [
    (-float("inf"), 5.0), (5.0, 10.0), (10.0, 15.0), (15.0, 20.0),
    (20.0, float("inf"))]
DEFAULT_BAND_NAMES = ["<5dB", "5-10dB", "10-15dB", "15-20dB", ">20dB"]


@dataclass
class PerformanceSlice:
    slice_name: str
    sample_count: int
    accuracy: float
    weighted_f1: float
    macro_f1: float
    uar: float
    per_class_f1: Dict[int, float]
    mean_confidence: float


def _slice_metrics(name: str, y_true, y_pred, conf) -> PerformanceSlice:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    _, _, f1, support = M.precision_recall_f1(y_true, y_pred)
    per_class = {int(c): float(f1[c]) for c in np.unique(y_true)}
    return PerformanceSlice(
        slice_name=name, sample_count=len(y_true),
        accuracy=M.accuracy(y_pred, y_true),
        weighted_f1=M.weighted_f1(y_pred, y_true),
        macro_f1=M.macro_f1(y_pred, y_true),
        uar=M.unweighted_average_recall(y_pred, y_true),
        per_class_f1=per_class,
        mean_confidence=float(np.mean(conf)) if len(conf) else 0.0)


def slice_by_language(y_true, y_pred, confidence, languages: Sequence[str]
                      ) -> Dict[str, PerformanceSlice]:
    """One slice per distinct language tag."""
    languages = np.asarray(languages)
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    confidence = np.asarray(confidence)
    out = {}
    for lang in sorted(set(languages.tolist())):
        m = languages == lang
        if m.any():
            out[lang] = _slice_metrics(f"Language_{lang}", y_true[m],
                                       y_pred[m], confidence[m])
    return out


def slice_by_snr(y_true, y_pred, confidence, snr_values,
                 bands: Optional[List[Tuple[float, float]]] = None,
                 names: Optional[List[str]] = None
                 ) -> Dict[str, PerformanceSlice]:
    """One slice per SNR band [low, high) (enhanced_evaluation.py:412-445)."""
    bands = bands or DEFAULT_SNR_BANDS
    names = names or DEFAULT_BAND_NAMES
    snr_values = np.asarray(snr_values)
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    confidence = np.asarray(confidence)
    out = {}
    for (low, high), name in zip(bands, names):
        m = (snr_values >= low) & (snr_values < high)
        if m.any():
            out[name] = _slice_metrics(f"SNR_{name}", y_true[m], y_pred[m],
                                       confidence[m])
    return out


def transfer_ratios(per_language: Dict[str, PerformanceSlice],
                    source_language: str = "en") -> Dict:
    """F1_target / F1_source per target + mean (cross_lingual_metrics.py:130-172)."""
    if source_language not in per_language:
        raise ValueError(f"source language {source_language!r} not evaluated")
    src_f1 = per_language[source_language].weighted_f1
    ratios = {}
    for lang, sl in per_language.items():
        if lang == source_language:
            continue
        ratios[lang] = sl.weighted_f1 / src_f1 if src_f1 > 0 else 0.0
    return {
        "source_language": source_language,
        "source_f1": src_f1,
        "transfer_ratios": ratios,
        "overall_transfer_ratio": float(np.mean(list(ratios.values()))) if ratios else 0.0,
    }


def slicing_report(slices: Dict[str, PerformanceSlice]) -> str:
    lines = [f"{'slice':>14} {'n':>6} {'acc':>7} {'wF1':>7} {'mF1':>7} "
             f"{'UAR':>7} {'conf':>7}"]
    for name, s in slices.items():
        lines.append(f"{name:>14} {s.sample_count:>6} {s.accuracy:7.3f} "
                     f"{s.weighted_f1:7.3f} {s.macro_f1:7.3f} {s.uar:7.3f} "
                     f"{s.mean_confidence:7.3f}")
    return "\n".join(lines)
