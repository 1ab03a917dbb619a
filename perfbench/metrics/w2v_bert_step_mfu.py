"""The whole step's share of the card's bf16 peak, in %, for the
configuration with w2v-BERT 2.0 as its audio encoder: the matmul and
convolution FLOPs of every batch completed in the window (the count of
perfbench/counts/conformer_flops.py at each batch's padded length and
rows) over the window and 989 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from perfbench.counts import conformer_flops, peaks


def read(record):
    cfg = record["config"]
    if cfg["audio"].get("backbone") != "w2v-bert":
        return None
    total = sum(conformer_flops.step_flops(cfg, audio_rows=b["audio_rows"],
                                           text_rows=b["text_rows"], samples=b["samples"],
                                           text_tokens=b["text_tokens"])
                for b in record["batches"])
    return 100.0 * total / record["window_s"] / peaks.BF16_FLOPS
