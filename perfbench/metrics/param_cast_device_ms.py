"""Device milliseconds per traced batch under `encoder_params`: the per-call
cast of the encoders' parameters to the compute dtype."""

from perfbench.harness.readers import range_ms

RANGES = [("models.model", "encoder_params")]


def read(record):
    return range_ms(record, "encoder_params")
