"""Device milliseconds per traced batch under `frontend_features`: the
front-end DSP, quality gates and conditioning."""

from perfbench.harness.readers import range_ms

RANGES = [("models.model", "frontend_features")]


def read(record):
    return range_ms(record, "frontend_features")
