"""Device milliseconds per traced batch under `self_attention`: the conformer's
self-attention with its relative-key term (models/w2v_bert.self_attention),
every layer's."""

from perfbench.harness.readers import range_ms

RANGES = [("models.w2v_bert", "self_attention")]


def read(record):
    return range_ms(record, "self_attention")
