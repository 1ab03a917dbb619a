"""Synchronising CUDA calls inside the step, per traced batch, by torch's
sync debug mode (the front-end DSP's gates read one bit each)."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr["batches"] or tr["host_syncs"] is None:
        return None
    return tr["host_syncs"] / len(tr["batches"])
