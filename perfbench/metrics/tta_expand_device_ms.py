"""Device milliseconds per traced batch under `tta_expand`: the TTA expansion:
two speed perturbations and two noise views."""

from perfbench.harness.readers import range_ms

RANGES = [("ops.audio_dsp", "tta_expand")]


def read(record):
    return range_ms(record, "tta_expand")
