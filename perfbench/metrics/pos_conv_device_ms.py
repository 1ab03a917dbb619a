"""Device milliseconds per traced batch under `_positional_conv`: the audio
encoder's grouped positional conv with its bias and GELU (the wav2vec2
family's; w2v-BERT has none)."""

from perfbench.harness.readers import range_ms

RANGES = [("models.wav2vec2", "_positional_conv")]


def read(record):
    return range_ms(record, "_positional_conv")
