"""Evaluation suite of the port (the JAX package's eval/ package).

evaluate    — eval CLI core: TTA, temperature calibration, OpenMax, reports
calibration — ECE/MCE, reliability diagram (evaluation/calibration_metrics.py)
openset     — OSCR, AUROC/AUPR, FPR@95, risk-coverage (evaluation/enhanced_evaluation.py)
slicing     — per-language / per-SNR slices, transfer ratios
wer         — word error rate with S/D/I backtrace, per-language tracking
robustness  — noise-at-SNR sweeps, code-mixing, OOD trigger rates
few_shot    — K-shot adaptation with recovery-rate accounting
benchmark   — latency/throughput/memory/scaling harness
cascade     — fit CascadeServer thresholds from --predictions_out files
academic    — the 8-part academic battery (evaluate_academic_complete.py)
zero_shot   — native-script hi/bn/te zero-shot cross-lingual evaluation
enhanced_pipeline — orchestrator over wer/openset/slicing with persistence
              (evaluation/enhanced_evaluation.py:490-685)
"""

from . import (academic, benchmark, calibration, cascade, enhanced_pipeline,
               evaluate, few_shot, openset, robustness, slicing, wer,
               zero_shot)
from .evaluate import evaluate_manifest, find_optimal_temperature

__all__ = ["academic", "benchmark", "calibration", "cascade",
           "enhanced_pipeline", "evaluate", "evaluate_manifest", "few_shot",
           "find_optimal_temperature", "openset", "robustness", "slicing",
           "wer", "zero_shot"]
