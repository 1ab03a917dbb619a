"""The whole step's share of the card's bf16 peak, in %: the matmul and
convolution FLOPs of every batch completed in the window (the frozen count
of perfbench/counts/flops.py at each batch's padded length and rows) over
the window and 989 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from perfbench.counts import flops, peaks


def read(record):
    cfg = record["config"]
    total = sum(flops.step_flops(cfg, audio_rows=b["audio_rows"], text_rows=b["text_rows"],
                                 samples=b["samples"], text_tokens=b["text_tokens"])
                for b in record["batches"])
    return 100.0 * total / record["window_s"] / peaks.BF16_FLOPS
