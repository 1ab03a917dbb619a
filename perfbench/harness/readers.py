"""Arithmetic the metric readers share: a range's device time per traced
batch, and a percentile over every sample."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def range_ms(record: dict, name: str) -> Optional[float]:
    """Device milliseconds per traced batch under the range of the port
    function `name`, the ranges inside it included; None where the traced
    window saw no device time under it."""
    tr = record.get("trace")
    if not tr or not tr["batches"] or name not in tr["range_s"]:
        return None
    return 1e3 * tr["range_s"][name] / len(tr["batches"])


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample with at least
    q % of all samples at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
