"""Device milliseconds per traced batch under `conv_module`: the conformer's
convolution modules (models/w2v_bert.conv_module: LN, pointwise, GLU, the
causal depthwise conv, LN, swish, pointwise), every layer's."""

from perfbench.harness.readers import range_ms

RANGES = [("models.w2v_bert", "conv_module")]


def read(record):
    return range_ms(record, "conv_module")
