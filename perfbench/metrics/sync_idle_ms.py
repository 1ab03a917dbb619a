"""Device idle milliseconds a traced batch in gaps that began while the host
was blocked in a read of a device value: the port's `read_gate` (the DSP
gates' predicates) or `device_bucket_table` (WavLM's bucket table, copied
from pageable host memory) innermost on the main thread
(harness/host_reads.py)."""

from perfbench.harness import host_reads

RANGES = host_reads.READS


def read(record):
    return host_reads.idle_ms(record, "sync")
