"""Device milliseconds per traced batch under `encode_text`: the text encoder
and its adapter."""

from perfbench.harness.readers import range_ms

RANGES = [("models.model", "encode_text")]


def read(record):
    return range_ms(record, "encode_text")
