"""Device milliseconds per traced batch under `encode_audio`: the audio
encoder, its conv extractor, adapter and feature fusion included."""

from perfbench.harness.readers import range_ms

RANGES = [("models.model", "encode_audio")]


def read(record):
    return range_ms(record, "encode_audio")
