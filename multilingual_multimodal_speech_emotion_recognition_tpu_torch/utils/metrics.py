"""Classification metrics (numpy) and the training log.

A copy of the JAX package's utils/metrics.py. weighted_f1 mirrors the
reference's src/utils.py:6-10 (sklearn f1_score(average='weighted')) in
plain numpy; MetricsWriter appends the train loop's JSONL records.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     num_classes: Optional[int] = None) -> np.ndarray:
    labels = np.asarray(labels).astype(np.int64)
    preds = np.asarray(preds).astype(np.int64)
    if num_classes is None:
        num_classes = int(max(labels.max(initial=0), preds.max(initial=0))) + 1
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def precision_recall_f1(labels: np.ndarray, preds: np.ndarray,
                        num_classes: Optional[int] = None):
    cm = confusion_matrix(labels, preds, num_classes)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    precision = np.divide(tp, pred_count, out=np.zeros_like(tp), where=pred_count > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp),
                   where=denom > 0)
    return precision, recall, f1, support


def weighted_f1(preds, labels, num_classes: Optional[int] = None) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    _, _, f1, support = precision_recall_f1(labels, preds, num_classes)
    total = support.sum()
    if total == 0:
        return 0.0
    return float((f1 * support).sum() / total)


def macro_f1(preds, labels, num_classes: Optional[int] = None) -> float:
    _, _, f1, support = precision_recall_f1(np.asarray(labels),
                                            np.asarray(preds), num_classes)
    present = support > 0
    return float(f1[present].mean()) if present.any() else 0.0


def unweighted_average_recall(preds, labels, num_classes: Optional[int] = None) -> float:
    """UAR (balanced accuracy) — enhanced_evaluation.py:110-121."""
    _, recall, _, support = precision_recall_f1(np.asarray(labels),
                                                np.asarray(preds), num_classes)
    present = support > 0
    return float(recall[present].mean()) if present.any() else 0.0


def accuracy(preds, labels) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    return float((preds == labels).mean()) if len(labels) else 0.0


def classification_report(labels, preds, target_names: Sequence[str]) -> str:
    precision, recall, f1, support = precision_recall_f1(
        np.asarray(labels), np.asarray(preds), num_classes=len(target_names))
    lines = [f"{'':>12} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
    for i, name in enumerate(target_names):
        lines.append(f"{name:>12} {precision[i]:9.3f} {recall[i]:9.3f} "
                     f"{f1[i]:9.3f} {int(support[i]):9d}")
    lines.append("")
    lines.append(f"{'accuracy':>12} {'':>9} {'':>9} "
                 f"{accuracy(preds, labels):9.3f} {int(support.sum()):9d}")
    lines.append(f"{'weighted avg':>12} {'':>9} {'':>9} "
                 f"{weighted_f1(preds, labels, len(target_names)):9.3f} "
                 f"{int(support.sum()):9d}")
    return "\n".join(lines)


class MetricsWriter:
    """Append-only JSONL metrics stream: one JSON object a line, with a
    "time" (time.time()) unless the record carries one."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: Dict) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
