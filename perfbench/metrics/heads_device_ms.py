"""Device milliseconds per traced batch under `model_heads` less the
`classifier_forward` range inside it: cross-modal attention, the two
poolings, the gated fusion and the heads' parameter cast."""

from perfbench.harness.readers import range_ms

RANGES = [("models.model", "model_heads"), ("models.classifier", "classifier_forward")]


def read(record):
    heads = range_ms(record, "model_heads")
    if heads is None:
        return None
    return heads - (range_ms(record, "classifier_forward") or 0.0)
