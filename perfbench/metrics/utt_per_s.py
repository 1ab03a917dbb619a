"""Clips labelled per second: every clip of every batch completed in the
window over the whole window (a TTA clip counts once, not per view)."""


def read(record):
    return sum(b["clips"] for b in record["batches"]) / record["window_s"]
