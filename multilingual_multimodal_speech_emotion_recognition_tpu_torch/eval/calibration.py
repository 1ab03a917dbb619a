"""Calibration metrics: ECE, MCE, reliability diagram, quality banding.

A copy of the JAX package's eval/calibration.py (plain numpy / Python).

Parity with the reference's src/evaluation/calibration_metrics.py:
  * 15 equal-width confidence bins over (lower, upper] (:58-83)
  * ECE = Σ (count/total)·|conf − acc| over non-empty bins (:29-41)
  * MCE = max |conf − acc| over bins (:44-48; note the reference takes the
    max over ALL bins including empty ones where both are 0 — replicated)
  * quality banding (<0.05 excellent, <0.10 good, <0.15 moderate, else
    poor) (:150-160 semantics)
  * reliability-diagram rendering (matplotlib, :121-203)
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np


class CalibrationMetrics(NamedTuple):
    ece: float
    mce: float
    bin_confidences: np.ndarray   # [n_bins]
    bin_accuracies: np.ndarray    # [n_bins]
    bin_counts: np.ndarray        # [n_bins]
    n_bins: int


def compute_calibration_metrics(predictions: np.ndarray, labels: np.ndarray,
                                probabilities: np.ndarray,
                                n_bins: int = 15) -> CalibrationMetrics:
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)
    confidences = np.max(np.asarray(probabilities), axis=1)

    edges = np.linspace(0.0, 1.0, n_bins + 1)
    bin_conf = np.zeros(n_bins)
    bin_acc = np.zeros(n_bins)
    bin_count = np.zeros(n_bins)
    for b in range(n_bins):
        in_bin = (confidences > edges[b]) & (confidences <= edges[b + 1])
        bin_count[b] = in_bin.sum()
        if bin_count[b] > 0:
            bin_acc[b] = float((predictions[in_bin] == labels[in_bin]).mean())
            bin_conf[b] = float(confidences[in_bin].mean())

    total = bin_count.sum()
    ece = float((bin_count / max(total, 1) * np.abs(bin_conf - bin_acc)).sum())
    mce = float(np.max(np.abs(bin_conf - bin_acc))) if n_bins else 0.0
    return CalibrationMetrics(ece=ece, mce=mce, bin_confidences=bin_conf,
                              bin_accuracies=bin_acc, bin_counts=bin_count,
                              n_bins=n_bins)


def calibration_quality(ece: float) -> str:
    """Quality banding (calibration_metrics.py report semantics)."""
    if ece < 0.05:
        return "excellent"
    if ece < 0.10:
        return "good"
    if ece < 0.15:
        return "moderate"
    return "poor"


def calibration_report(m: CalibrationMetrics) -> str:
    lines = [
        "Calibration Metrics",
        "===================",
        f"ECE: {m.ece:.4f} ({calibration_quality(m.ece)})",
        f"MCE: {m.mce:.4f}",
        f"Bins: {m.n_bins}",
        "",
        f"{'bin':>4} {'range':>13} {'count':>7} {'conf':>7} {'acc':>7}",
    ]
    edges = np.linspace(0.0, 1.0, m.n_bins + 1)
    for b in range(m.n_bins):
        if m.bin_counts[b] > 0:
            lines.append(f"{b:>4} ({edges[b]:.2f},{edges[b+1]:.2f}] "
                         f"{int(m.bin_counts[b]):>7} {m.bin_confidences[b]:7.3f} "
                         f"{m.bin_accuracies[b]:7.3f}")
    return "\n".join(lines)


def plot_reliability_diagram(m: CalibrationMetrics,
                             save_path: Optional[str] = None):
    """Reliability diagram (calibration_metrics.py:121-157). Returns the
    figure; saves to save_path if given. Lazy matplotlib import."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    edges = np.linspace(0.0, 1.0, m.n_bins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "--", color="gray", label="perfect calibration")
    nonzero = m.bin_counts > 0
    ax.bar(centers[nonzero], m.bin_accuracies[nonzero], width=1.0 / m.n_bins,
           alpha=0.7, edgecolor="black", label="accuracy")
    ax.plot(centers[nonzero], m.bin_confidences[nonzero], "o-",
            label="confidence")
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.set_title(f"Reliability Diagram (ECE={m.ece:.4f}, MCE={m.mce:.4f})")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
