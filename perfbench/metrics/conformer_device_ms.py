"""Device milliseconds per traced batch under `conformer`: w2v-BERT 2.0's
feature projection and its conformer layers (models/w2v_bert.conformer)."""

from perfbench.harness.readers import range_ms

RANGES = [("models.w2v_bert", "conformer")]


def read(record):
    return range_ms(record, "conformer")
