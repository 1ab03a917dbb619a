"""Kernel A1's (csrc/residual_stack.cu) share of its roofline, in %: its
mean least time over the traced batches (per batch the larger of its
float32 operations over the CUDA cores' peak and its bytes over HBM's, at
the batch's rows; one launch a step) over its mean kernel time in the
trace (kernels matched by name)."""

from perfbench.counts import flops

KERNEL = "residual_stack_kernel"


def read(record):
    tr = record.get("trace")
    if not tr or not tr["batches"]:
        return None
    found = [(n, s) for name, (n, s) in tr["kernel_s"].items() if KERNEL in name]
    launches = sum(n for n, _ in found)
    if not launches:
        return None
    m = record["config"]["model"]
    least = sum(flops.a1_least_seconds(b["audio_rows"], m["classifier_layers"],
                                       m["classifier_base_dim"]) for b in tr["batches"])
    return 100.0 * (least / len(tr["batches"])) / (sum(s for _, s in found) / launches)
