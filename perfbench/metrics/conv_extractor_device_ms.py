"""Device milliseconds per traced batch under `feature_encoder`: the strided
conv extractor of the audio encoder."""

from perfbench.harness.readers import range_ms

RANGES = [("models.wav2vec2", "feature_encoder")]


def read(record):
    return range_ms(record, "feature_encoder")
