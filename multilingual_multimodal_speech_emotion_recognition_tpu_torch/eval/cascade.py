"""Fit CascadeServer operating points from per-utterance prediction files.

A copy of the JAX package's eval/cascade.py (plain numpy / Python).

`serving.CascadeServer` routes on two scalars: escalate when the
student's calibrated max-prob confidence is BELOW `confidence_threshold`,
or when its raw-logit energy OOD score is ABOVE `energy_threshold`.
This module picks those thresholds from data the framework already
produces — `cli/eval.py --predictions_out` JSONL for the student (and
optionally the teacher, scored on the SAME manifest so rows join by
manifest `index`) — against an explicit operating target:

  * `escalation_budget`: at most this fraction of traffic may escalate;
    maximize accuracy subject to it.
  * `min_accuracy`: reach at least this accuracy; minimize escalations.
  * both: minimize escalations among points satisfying both; if the
    budget makes the accuracy target infeasible, fall back to the best
    accuracy within budget and say so (`feasible: false`).

"Accuracy" is cascade accuracy when teacher predictions are provided
(escalated rows take the teacher's correctness) and selective accuracy
on the answered set otherwise (risk-coverage semantics, matching
`eval/openset.py:risk_coverage_curve`).

The reference has no deployment tooling at all; this is the natural
companion to the distillation path (`train/distill.py`) it also lacks.
No reference counterpart.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _sweep(confidence: np.ndarray, correct_student: np.ndarray,
           correct_teacher: Optional[np.ndarray]):
    """All distinct operating points of the rule `escalate iff conf < t`.

    Returns (thresholds, escalation_rate, accuracy) where index k means
    "the k lowest-confidence rows escalate". thresholds[k] is the
    smallest t realizing that point (strict <, so t = k-th sorted value;
    t just above max(conf) escalates everything)."""
    n = confidence.shape[0]
    order = np.argsort(confidence, kind="stable")
    conf_sorted = confidence[order]
    stu = correct_student[order].astype(np.float64)
    tea = (correct_teacher[order].astype(np.float64)
           if correct_teacher is not None else None)

    # prefix[k] = sum of first k (escalated), suffix = answered remainder
    stu_prefix = np.concatenate([[0.0], np.cumsum(stu)])
    answered_correct = stu_prefix[-1] - stu_prefix          # [n+1]
    answered_n = n - np.arange(n + 1)
    if tea is not None:
        tea_prefix = np.concatenate([[0.0], np.cumsum(tea)])
        accuracy = (tea_prefix + answered_correct) / n      # cascade
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            accuracy = answered_correct / answered_n        # selective
        accuracy[answered_n == 0] = 1.0                     # vacuous
    # ties in confidence: only the LAST point of a tied run is realizable
    # by a strict-< threshold; mask the rest so we never pick an
    # unreachable operating point.
    thresholds = np.concatenate([conf_sorted, [np.nextafter(
        conf_sorted[-1], np.inf) if n else 1.0]])
    realizable = np.ones(n + 1, bool)
    if n:
        realizable[1:n] = conf_sorted[1:] != conf_sorted[:-1]
    rate = np.arange(n + 1) / n if n else np.zeros(1)
    return thresholds, rate, accuracy, realizable


def fit_confidence_threshold(
        confidence: Sequence[float], correct_student: Sequence[bool], *,
        correct_teacher: Optional[Sequence[bool]] = None,
        escalation_budget: Optional[float] = None,
        min_accuracy: Optional[float] = None) -> Dict:
    """Pick `confidence_threshold` for CascadeServer (see module doc)."""
    if escalation_budget is None and min_accuracy is None:
        raise ValueError("set escalation_budget and/or min_accuracy")
    conf = np.asarray(confidence, np.float64)
    stu = np.asarray(correct_student, bool)
    tea = (np.asarray(correct_teacher, bool)
           if correct_teacher is not None else None)
    if conf.ndim != 1 or conf.shape != stu.shape or (
            tea is not None and tea.shape != stu.shape):
        raise ValueError("confidence/correct arrays must be 1-D, same len")
    n = conf.shape[0]
    if n == 0:
        raise ValueError("no prediction rows")

    thr, rate, acc, realizable = _sweep(conf, stu, tea)
    ok = realizable.copy()
    feasible = True
    if escalation_budget is not None:
        ok &= rate <= escalation_budget + 1e-12
    if min_accuracy is not None:
        with_acc = ok & (acc >= min_accuracy - 1e-12)
        if with_acc.any():
            ok = with_acc
            # minimize escalations at the accuracy target
            k = int(np.flatnonzero(ok)[np.argmin(rate[ok])])
        else:
            feasible = False                 # best accuracy within budget
            k = int(np.flatnonzero(ok)[np.argmax(acc[ok])])
    else:
        # budget only: maximize accuracy within it (ties -> fewer escal.)
        idx = np.flatnonzero(ok)
        k = int(idx[np.argmax(acc[idx])])

    out = {
        "confidence_threshold": float(thr[k]),
        "escalation_rate": float(rate[k]),
        "accuracy": float(acc[k]),
        "accuracy_kind": "cascade" if tea is not None else "selective",
        "student_accuracy": float(stu.mean()),
        "n": n,
        "feasible": feasible,
    }
    if tea is not None:
        out["teacher_accuracy"] = float(tea.mean())
    return out


def fit_energy_threshold(energy: Sequence[float],
                         correct_student: Sequence[bool], *,
                         quantile: float = 0.99) -> Dict:
    """Escalate-on-OOD bar: the `quantile` of raw-logit energy over rows
    the student got RIGHT (energy is less negative = more OOD-like, so
    rows above the bar look unlike anything the student handles well).
    Reports the overall fraction that bar would escalate on this set."""
    e = np.asarray(energy, np.float64)
    stu = np.asarray(correct_student, bool)
    base = e[stu] if stu.any() else e
    t = float(np.quantile(base, quantile))
    return {"energy_threshold": t,
            "energy_escalation_rate": float((e > t).mean()),
            "quantile": float(quantile)}


def read_predictions(path: str) -> List[Dict]:
    """Rows of a `cli/eval.py --predictions_out` JSONL file."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def fit_from_predictions(student_rows: Sequence[Dict],
                         teacher_rows: Optional[Sequence[Dict]] = None, *,
                         escalation_budget: Optional[float] = None,
                         min_accuracy: Optional[float] = None,
                         energy_quantile: Optional[float] = None) -> Dict:
    """Join student/teacher prediction rows by manifest `index`, fit the
    confidence threshold (and optionally the energy bar), and return the
    CascadeServer kwargs plus the operating point."""
    conf = [r["confidence"] for r in student_rows]
    stu = [r["correct"] for r in student_rows]
    tea = None
    if teacher_rows is not None:
        by_idx = {r["index"]: r["correct"] for r in teacher_rows}
        missing = [r["index"] for r in student_rows
                   if r["index"] not in by_idx]
        if missing:
            raise ValueError(
                f"teacher predictions missing manifest indices "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}; score "
                f"both tiers on the same manifest")
        tea = [by_idx[r["index"]] for r in student_rows]
    out = fit_confidence_threshold(
        conf, stu, correct_teacher=tea,
        escalation_budget=escalation_budget, min_accuracy=min_accuracy)
    if energy_quantile is not None:
        out.update(fit_energy_threshold(
            [r["energy"] for r in student_rows], stu,
            quantile=energy_quantile))
    return out
