"""Open-set evaluation: OSCR, AUROC/AUPR, FPR@95TPR, risk-coverage.

A copy of the JAX package's eval/openset.py (plain numpy / Python).

Parity with the reference's src/evaluation/enhanced_evaluation.py:
  * OSCR over 101 thresholds; unknowns marked y_true == -1; score =
    max(TPR − FPR) (:199-245)
  * AUROC / AUPR over known-vs-unknown confidence (:266-288), implemented
    natively (trapezoid over the exact ROC/PR step curves, matching
    sklearn.roc_curve/auc)
  * FPR at the threshold whose TPR is closest to 95% (:290-296)
  * risk-coverage curve + trapezoid AUC + optimal operating point with
    coverage > 0.5 (:299-366)
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_curve_np(y_true: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) on the unique-score step grid (sklearn
    semantics: thresholds descending, curve anchored at (0,0))."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    s = scores[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[idx].astype(np.float64)
    fps = (idx + 1 - tps).astype(np.float64)
    P = max(y_true.sum(), 1)
    N = max((~y_true).sum(), 1)
    tpr = np.r_[0.0, tps / P]
    fpr = np.r_[0.0, fps / N]
    return fpr, tpr, np.r_[s[0] + 1, s[idx]]


def auroc(known_scores: np.ndarray, unknown_scores: np.ndarray) -> float:
    y = np.r_[np.ones(len(known_scores)), np.zeros(len(unknown_scores))]
    s = np.r_[known_scores, unknown_scores]
    if len(known_scores) == 0 or len(unknown_scores) == 0:
        return 0.0
    fpr, tpr, _ = roc_curve_np(y, s)
    return float(np.trapezoid(tpr, fpr))


def aupr(known_scores: np.ndarray, unknown_scores: np.ndarray) -> float:
    """Area under precision-recall with the positive class = known
    (enhanced_evaluation.py:280-288; trapezoid over the PR steps)."""
    if len(known_scores) == 0 or len(unknown_scores) == 0:
        return 0.0
    y = np.r_[np.ones(len(known_scores)), np.zeros(len(unknown_scores))].astype(bool)
    s = np.r_[known_scores, unknown_scores]
    order = np.argsort(-s, kind="stable")
    y = y[order]
    tp = np.cumsum(y).astype(np.float64)
    n = np.arange(1, len(y) + 1, dtype=np.float64)
    precision = tp / n
    recall = tp / max(y.sum(), 1)
    # prepend the (recall=0, precision=1) anchor
    recall = np.r_[0.0, recall]
    precision = np.r_[1.0, precision]
    return float(np.trapezoid(precision, recall))


def fpr_at_95_tpr(known_scores: np.ndarray, unknown_scores: np.ndarray) -> float:
    """FPR at the ROC point whose TPR is closest to 95%
    (enhanced_evaluation.py:290-296), on the exact score grid — usable for
    unbounded scores (energy) where compute_oscr's [0,1] threshold sweep
    does not apply."""
    if len(known_scores) == 0 or len(unknown_scores) == 0:
        return 1.0
    y = np.r_[np.ones(len(known_scores)), np.zeros(len(unknown_scores))]
    s = np.r_[known_scores, unknown_scores]
    fpr, tpr, _ = roc_curve_np(y, s)
    return float(fpr[int(np.argmin(np.abs(tpr - 0.95)))])


def compute_oscr(confidence_scores: np.ndarray, y_true: np.ndarray,
                 y_pred: np.ndarray, thresholds: np.ndarray | None = None
                 ) -> Dict:
    """OSCR battery (enhanced_evaluation.py:199-264). y_true == -1 marks
    unknown/open-set samples."""
    confidence_scores = np.asarray(confidence_scores, np.float64)
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if thresholds is None:
        thresholds = np.linspace(0.0, 1.0, 101)

    known = y_true != -1
    unknown = ~known
    if not known.any() or not unknown.any():
        return {"oscr_score": 0.0, "thresholds": thresholds, "oscr_curve": [],
                "tpr_curve": [], "fpr_curve": [], "auroc": 0.0, "aupr": 0.0,
                "fpr_at_95tpr": 1.0, "optimal_threshold": 0.0}

    kc = confidence_scores[known]
    uc = confidence_scores[unknown]
    correct = (y_pred[known] == y_true[known])

    # vectorized threshold sweep
    tpr = ((correct[None, :] & (kc[None, :] >= thresholds[:, None]))
           .sum(axis=1) / known.sum())
    fpr = (uc[None, :] >= thresholds[:, None]).sum(axis=1) / unknown.sum()
    oscr = tpr - fpr
    best = int(np.argmax(oscr))

    # FPR at TPR closest to 0.95 (:290-296)
    fpr95 = float(fpr[int(np.argmin(np.abs(tpr - 0.95)))])

    return {
        "oscr_score": float(oscr[best]),
        "optimal_threshold": float(thresholds[best]),
        "thresholds": thresholds,
        "oscr_curve": oscr.tolist(),
        "tpr_curve": tpr.tolist(),
        "fpr_curve": fpr.tolist(),
        "auroc": auroc(kc, uc),
        "aupr": aupr(kc, uc),
        "fpr_at_95tpr": fpr95,
    }


def risk_coverage_curve(confidence_scores: np.ndarray, y_true: np.ndarray,
                        y_pred: np.ndarray,
                        thresholds: np.ndarray | None = None) -> Dict:
    """Risk-coverage analysis (enhanced_evaluation.py:299-366)."""
    confidence_scores = np.asarray(confidence_scores, np.float64)
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if thresholds is None:
        thresholds = np.linspace(0.0, 1.0, 101)

    n = max(len(confidence_scores), 1)
    above = confidence_scores[None, :] >= thresholds[:, None]   # [T, N]
    cov_counts = above.sum(axis=1)
    coverage = cov_counts / n
    wrong = (y_pred != y_true)
    errors = (above & wrong[None, :]).sum(axis=1)
    risk = np.divide(errors, cov_counts,
                     out=np.zeros(len(thresholds)), where=cov_counts > 0)

    rc_auc = float(np.trapezoid(risk, coverage))
    reasonable = coverage > 0.5
    if reasonable.any():
        idxs = np.where(reasonable)[0]
        best = idxs[int(np.argmin(risk[reasonable]))]
    else:
        best = len(thresholds) - 1
    return {
        "thresholds": thresholds,
        "coverage_rates": coverage.tolist(),
        "risk_rates": risk.tolist(),
        "error_rates": errors.tolist(),
        "risk_coverage_auc": rc_auc,
        "optimal_threshold": float(thresholds[best]),
        "optimal_coverage": float(coverage[best]),
        "optimal_risk": float(risk[best]),
    }
