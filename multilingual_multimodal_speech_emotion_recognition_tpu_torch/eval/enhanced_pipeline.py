"""Enhanced evaluation pipeline orchestrator.

A copy of the JAX package's eval/enhanced_pipeline.py (plain numpy / Python).

Parity with EnhancedEvaluationPipeline
(the reference's src/evaluation/enhanced_evaluation.py:490-685): one entry
point that chains (1) the WER-vs-UAR paired significance test when
raw/processed audio metrics are supplied, (2) open-set metrics
(OSCR/AUROC/AUPR/FPR@95 when unknown-class labels are present), (3)
risk-coverage analysis, (4) performance slicing by language and by SNR
band, then writes evaluation_results.json + a text report. The individual
metric engines live in eval/wer.py, eval/openset.py, eval/slicing.py —
this module is only the orchestration + persistence layer, like the
reference's class.

The reference takes loose dicts (`model_results`, `evaluation_data`); the
same keys are accepted here as keyword arguments.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from . import openset as osr
from . import slicing
from . import wer as wer_mod


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def run_enhanced_evaluation(
        *, y_true: np.ndarray, y_pred: np.ndarray,
        confidence_scores: Optional[np.ndarray] = None,
        unknown_mask: Optional[np.ndarray] = None,
        languages: Optional[Sequence[str]] = None,
        snr_values: Optional[np.ndarray] = None,
        raw_audio_metrics: Optional[Dict[str, float]] = None,
        processed_audio_metrics: Optional[Dict[str, float]] = None,
        output_dir: Optional[str] = None) -> Dict:
    """Run every enhanced-evaluation stage whose inputs are present
    (enhanced_evaluation.py:510-560 runs each block conditionally the same
    way). Returns the results dict; also persists JSON + report when
    `output_dir` is given."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    results: Dict = {}

    # 1. WER vs UAR paired significance test (:75-161)
    if raw_audio_metrics is not None and processed_audio_metrics is not None:
        results["wer_uar_analysis"] = wer_mod.paired_wer_uar_test(
            raw_audio_metrics, processed_audio_metrics, len(y_true))

    if confidence_scores is not None:
        conf = np.asarray(confidence_scores)
        # 2. open-set metrics (:199-296) — OSCR marks unknowns as y_true=-1
        if unknown_mask is not None:
            y_os = np.where(np.asarray(unknown_mask, bool), -1, y_true)
            results["open_set_metrics"] = osr.compute_oscr(conf, y_os, y_pred)
        # 3. risk-coverage analysis (:299-366)
        results["risk_coverage_analysis"] = osr.risk_coverage_curve(
            conf, y_true, y_pred)

    # 4. performance slicing (:369-489)
    slices: Dict[str, slicing.PerformanceSlice] = {}
    conf_or_zeros = (np.asarray(confidence_scores)
                     if confidence_scores is not None
                     else np.zeros(len(y_true)))
    if languages is not None:
        slices.update(slicing.slice_by_language(
            y_true, y_pred, conf_or_zeros, list(languages)))
    if snr_values is not None:
        slices.update(slicing.slice_by_snr(
            y_true, y_pred, conf_or_zeros, np.asarray(snr_values)))
    if slices:
        results["performance_slices"] = {k: vars(v) for k, v in slices.items()}

    results["evaluation_report"] = generate_enhanced_report(results, slices)
    if output_dir:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "evaluation_results.json").write_text(json.dumps(
            {k: v for k, v in results.items() if k != "evaluation_report"},
            default=_json_default, indent=2))
        (out / "evaluation_report.txt").write_text(
            results["evaluation_report"])
    return results


def generate_enhanced_report(results: Dict,
                             slices: Optional[Dict] = None) -> str:
    """Text report (enhanced_evaluation.py:586-666 structure)."""
    lines = ["=" * 60, "ENHANCED EVALUATION REPORT", "=" * 60]
    wu = results.get("wer_uar_analysis")
    if wu:
        lines += ["", "WER vs UAR paired test:"]
        for k, v in wu.items():
            lines.append(f"  {k}: {v}")
    om = results.get("open_set_metrics")
    if om:
        lines += ["", "Open-set metrics:"]
        for k in ("oscr_score", "auroc", "aupr", "fpr_at_95tpr"):
            if k in om:
                lines.append(f"  {k}: {om[k]:.4f}")
    rc = results.get("risk_coverage_analysis")
    if rc:
        lines += ["", "Risk-coverage:"]
        for k in ("risk_coverage_auc", "optimal_threshold",
                  "optimal_coverage", "optimal_risk"):
            if k in rc:
                lines.append(f"  {k}: {rc[k]:.4f}")
    if slices:
        lines += ["", "Performance slices:", slicing.slicing_report(slices)]
    lines.append("=" * 60)
    return "\n".join(lines)
