"""Device milliseconds per traced batch under `fbank`: the log-mel fbank of
w2v-BERT 2.0's input (models/w2v_bert.fbank), computed on the card in
float32."""

from perfbench.harness.readers import range_ms

RANGES = [("models.w2v_bert", "fbank")]


def read(record):
    return range_ms(record, "fbank")
