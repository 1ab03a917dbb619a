"""The card's idle time inside the step, split by what the host was doing
when each gap began: blocked in a read of a device value, or still
launching.

The port makes the host reads of its eval step in two functions, which the
readers of these numbers name in their `RANGES`, so that the traced window
wraps them as it wraps the stage functions: `frontend.conditioning.read_gate`
(the front-end DSP's gate predicates) and `models.wav2vec2.device_bucket_table`
(WavLM's bucket table, copied from pageable host memory). `trace.reduce`
puts each idle gap down to the innermost range open on the main thread when
it began (`idle_by_host_range`). A gap begun in one of the reads is sync
idle; one begun inside the step with neither read innermost is launch idle,
the card waiting for the host's next launch; one begun in the loop's other
ranges (the wait on the prefetch queue, the copy of the logits to the host)
is neither. A port without these functions, or a window in which no device
operation ran, gives neither number.
"""

from __future__ import annotations

import importlib
from typing import Optional

from .runner import PORT

READS = [("frontend.conditioning", "read_gate"), ("models.wav2vec2", "device_bucket_table")]
# window.run's ranges outside the step, the whole window's, and none at all
OUTSIDE_STEP = {"window", "prefetch_wait", "to_host", "(no range)"}


def port_has_reads() -> bool:
    """Whether the port makes its reads in the functions READS names."""
    found = False
    for mod_name, attr in READS:
        try:
            found |= callable(getattr(importlib.import_module(f"{PORT}.{mod_name}"), attr,
                                      None))
        except ImportError:
            pass
    return found


def idle_ms(record: dict, kind: str) -> Optional[float]:
    """Device idle milliseconds a traced batch in gaps of `kind`: "sync"
    (begun in a read) or "launch" (begun inside the step, no read
    innermost); None where the run was not traced, no device operation
    ran or the port lacks the read functions."""
    tr = record.get("trace")
    if not tr or not tr["batches"] or tr["busy_s"] <= 0 or not port_has_reads():
        return None
    reads = {attr for _, attr in READS}
    by = tr["idle_by_host_range"]
    if kind == "sync":
        s = sum(v for k, v in by.items() if k in reads)
    else:
        s = sum(v for k, v in by.items() if k not in reads | OUTSIDE_STEP)
    return 1e3 * s / len(tr["batches"])
