"""Device milliseconds per traced batch under `classifier_forward`: the
classifier: input projection, A1 (the residual stack), OpenMax."""

from perfbench.harness.readers import range_ms

RANGES = [("models.classifier", "classifier_forward")]


def read(record):
    return range_ms(record, "classifier_forward")
