"""Process start to the first timed batch: imports, the kernels' build or
load, weights, traffic, the warm-up passes."""


def read(record):
    return record["setup_s"]
