"""Device idle milliseconds a traced batch in gaps that began inside the
step with neither of the port's host reads innermost on the main thread:
the card waiting for the host to launch its next work
(harness/host_reads.py)."""

from perfbench.harness import host_reads

RANGES = host_reads.READS


def read(record):
    return host_reads.idle_ms(record, "launch")
