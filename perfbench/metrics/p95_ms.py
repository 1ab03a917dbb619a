"""95th percentile (nearest rank), over every batch completed in the
window, of its latency: from the step's call to its outputs on the host."""

from perfbench.harness.readers import percentile


def read(record):
    return 1e3 * percentile([b["latency_s"] for b in record["batches"]], 95)
