"""Word-error-rate tooling with substitution/deletion/insertion backtrace,
per-language tracking, and confidence correlation.

A copy of the JAX package's eval/wer.py (plain numpy / Python).

Parity with the reference's src/evaluation/asr_performance_tracker.py
(:84-137 alignment backtrace; :139-230 per-language stats; :232-300
report — the reference's print_report crashes on undefined
total_words/total_errors at :295-296, fixed here) and the simpler
aggregate WER of enhanced_evaluation.py:75-108.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


def levenshtein(ref_words: List[str], hyp_words: List[str]) -> int:
    """Word-level edit distance (enhanced_evaluation.py:91-108)."""
    m, n = len(ref_words), len(hyp_words)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            if ref_words[i - 1] == hyp_words[j - 1]:
                cur[j] = prev[j - 1]
            else:
                cur[j] = min(prev[j], cur[j - 1], prev[j - 1]) + 1
        prev = cur
    return prev[n]


def align_counts(ref_words: List[str], hyp_words: List[str]
                 ) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) via full DP backtrace
    (asr_performance_tracker.py:84-137)."""
    m, n = len(ref_words), len(hyp_words)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if ref_words[i - 1] == hyp_words[j - 1]:
                dp[i, j] = dp[i - 1, j - 1]
            else:
                dp[i, j] = min(dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1]) + 1
    subs = dels = ins = 0
    i, j = m, n
    while i > 0 or j > 0:
        if (i > 0 and j > 0 and ref_words[i - 1] == hyp_words[j - 1]
                and dp[i, j] == dp[i - 1, j - 1]):
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins


def wer(reference_texts: List[str], predicted_texts: List[str]) -> float:
    """Aggregate WER in percent (enhanced_evaluation.py:75-89)."""
    total_errors, total_words = 0, 0
    for ref, hyp in zip(reference_texts, predicted_texts):
        rw, hw = ref.lower().split(), hyp.lower().split()
        total_errors += levenshtein(rw, hw)
        total_words += len(rw)
    return (total_errors / total_words) * 100 if total_words > 0 else 0.0


@dataclass
class LanguageWERStats:
    total_words: int = 0
    substitutions: int = 0
    deletions: int = 0
    insertions: int = 0
    confidences: List[float] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / self.total_words if self.total_words else 0.0


class ASRPerformanceTracker:
    """Per-language WER/confidence/latency tracker."""

    def __init__(self):
        self.stats: Dict[str, LanguageWERStats] = {}

    def add_result(self, reference: str, hypothesis: str, *,
                   language: str = "unknown", confidence: float = 0.0,
                   latency: float = 0.0) -> None:
        st = self.stats.setdefault(language, LanguageWERStats())
        rw, hw = reference.lower().split(), hypothesis.lower().split()
        s, d, i = align_counts(rw, hw)
        st.total_words += len(rw)
        st.substitutions += s
        st.deletions += d
        st.insertions += i
        st.confidences.append(confidence)
        st.latencies.append(latency)

    def summary(self) -> Dict:
        total_words = sum(s.total_words for s in self.stats.values())
        total_errors = sum(s.errors for s in self.stats.values())
        all_conf = [c for s in self.stats.values() for c in s.confidences]
        per_lang = {}
        for lang, s in sorted(self.stats.items()):
            per_lang[lang] = {
                "wer": s.wer, "words": s.total_words,
                "substitutions": s.substitutions, "deletions": s.deletions,
                "insertions": s.insertions,
                "mean_confidence": float(np.mean(s.confidences)) if s.confidences else 0.0,
                "mean_latency": float(np.mean(s.latencies)) if s.latencies else 0.0,
            }
        # confidence-WER correlation across languages (tracker :260-280)
        corr = 0.0
        if len(per_lang) >= 2:
            wers = [v["wer"] for v in per_lang.values()]
            confs = [v["mean_confidence"] for v in per_lang.values()]
            if np.std(wers) > 0 and np.std(confs) > 0:
                corr = float(np.corrcoef(wers, confs)[0, 1])
        return {
            "overall_wer": 100.0 * total_errors / total_words if total_words else 0.0,
            "total_words": total_words,
            "total_errors": total_errors,
            "mean_confidence": float(np.mean(all_conf)) if all_conf else 0.0,
            "per_language": per_lang,
            "confidence_wer_correlation": corr,
        }

    def report(self) -> str:
        s = self.summary()
        lines = ["ASR Performance Report", "======================",
                 f"Overall WER: {s['overall_wer']:.2f}% "
                 f"({s['total_errors']}/{s['total_words']} words)",
                 f"Mean confidence: {s['mean_confidence']:.3f}", ""]
        for lang, v in s["per_language"].items():
            lines.append(f"  {lang}: WER {v['wer']:.2f}% "
                         f"(S {v['substitutions']} D {v['deletions']} "
                         f"I {v['insertions']} / {v['words']} words), "
                         f"conf {v['mean_confidence']:.3f}")
        return "\n".join(lines)


def paired_wer_uar_test(raw_metrics: Dict[str, float],
                        processed_metrics: Dict[str, float],
                        sample_count: int) -> Dict:
    """Processing-impact paired test (enhanced_evaluation.py:123-161):
    effect size = improvement / baseline, significant iff |effect| > 0.1
    and n > 30."""
    raw_wer = raw_metrics.get("wer", 0.0)
    raw_uar = raw_metrics.get("uar", 0.0)
    proc_wer = processed_metrics.get("wer", 0.0)
    proc_uar = processed_metrics.get("uar", 0.0)
    wer_improvement = raw_wer - proc_wer
    uar_improvement = proc_uar - raw_uar
    wer_effect = wer_improvement / (raw_wer + 1e-8)
    uar_effect = uar_improvement / (raw_uar + 1e-8)
    return {
        "raw_wer": raw_wer, "raw_uar": raw_uar,
        "processed_wer": proc_wer, "processed_uar": proc_uar,
        "wer_improvement": wer_improvement,
        "uar_improvement": uar_improvement,
        "wer_significant": abs(wer_effect) > 0.1 and sample_count > 30,
        "uar_significant": abs(uar_effect) > 0.1 and sample_count > 30,
        "processing_effectiveness": (wer_improvement + uar_improvement) / 2,
        "sample_count": sample_count,
    }
