"""Bucket-edge autotuning for the fixed-shape input pipeline.

A copy of the JAX package's data/bucketing.py. The reference pads every
batch to its own max length (src/audio_encoder.py:147-171). The pipeline
instead buckets clips into a small static set of lengths
(DataConfig.audio_buckets) and pads up to the bucket cap, so that the
port's batches are the JAX package's, row for row. The caps are a
performance knob:

  * too few / badly-placed caps -> padded samples, i.e. wasted FLOPs and
    memory traffic roughly linear in padded length (conv extractor and DSP
    are linear in T; self-attention is quadratic but S<=1499 keeps it a
    minor term at these shapes);
  * too many caps -> more distinct shapes, each with its own allocator
    sizes and library plans on the card.

`optimal_buckets` picks K caps that exactly minimize total padded samples
for a measured duration distribution (the manifest header probe is cheap:
data/pipeline.py:SERDataset.audio_length). This is a contiguous
partition of the sorted durations, solved by dynamic programming over
unique values — O(u^2 K) for u unique durations, exact, no heuristics.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def seconds_to_samples(seconds: float, sample_rate: int) -> int:
    """Bucket-cap seconds -> samples. round(), not int(): truncation breaks
    the never-truncate guarantee on caps whose float product lands just
    under the integer they encode (8.04 * 16000 = 128639.999..., so
    int() would shave the longest clip to 128639 samples and push interior
    caps' own clips into the next bucket). Every autotuned cap is a whole
    number of centiseconds, so the product is within 1e-6 of an integer."""
    return int(round(seconds * sample_rate))


def padded_fraction(lengths: Sequence[int],
                    caps: Sequence[int]) -> float:
    """Fraction of processed samples that are padding under `caps`.

    `lengths` and `caps` in the same unit (samples or seconds). Clips
    longer than every cap land in the largest bucket (they are truncated
    upstream by max_audio_seconds; BucketedLoader._bucket_of sends them
    to the last bucket), contributing zero padding here.
    """
    lengths = np.asarray(lengths, np.float64)
    caps_sorted = np.sort(np.asarray(caps, np.float64))
    # first cap >= length; lengths beyond all caps -> last cap
    idx = np.searchsorted(caps_sorted, lengths, side="left")
    idx = np.minimum(idx, len(caps_sorted) - 1)
    assigned = caps_sorted[idx]  # buffer length actually processed
    pad = np.maximum(assigned - lengths, 0.0).sum()
    total = assigned.sum()
    return float(pad / total) if total else 0.0


def optimal_buckets(lengths: Sequence[int], k: int) -> List[int]:
    """Exactly minimize total padded samples with at most `k` caps.

    Returns sorted caps (same unit as `lengths`); the largest equals
    max(lengths) so no clip is truncated by bucketing. If there are at
    most `k` unique lengths, returns them all (zero padding).
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    lengths = np.asarray(lengths)
    if lengths.size == 0:
        raise ValueError("no lengths to bucket")
    vals, counts = np.unique(lengths, return_counts=True)
    u = len(vals)
    if u <= k:
        return [int(v) for v in vals]

    vals_f = vals.astype(np.float64)
    counts_f = counts.astype(np.float64)
    # prefix sums for O(1) group cost: cost(i..j) = vals[j]*C - S over i..j
    pc = np.concatenate([[0.0], np.cumsum(counts_f)])
    ps = np.concatenate([[0.0], np.cumsum(counts_f * vals_f)])

    def cost(i: int, j: int) -> float:  # inclusive group [i, j], cap vals[j]
        return vals_f[j] * (pc[j + 1] - pc[i]) - (ps[j + 1] - ps[i])

    INF = float("inf")
    dp = np.full((u, k + 1), INF)
    back = np.zeros((u, k + 1), np.int64)
    for j in range(u):
        dp[j][1] = cost(0, j)
    for m in range(2, k + 1):
        for j in range(m - 1, u):
            best, arg = INF, 0
            for i in range(m - 1, j + 1):  # group m is vals[i..j]
                c = dp[i - 1][m - 1] + cost(i, j)
                if c < best:
                    best, arg = c, i
            dp[j][m] = best
            back[j][m] = arg
    caps: List[int] = []
    j, m = u - 1, k
    while m >= 1:
        caps.append(int(vals[j]))
        i = back[j][m] if m > 1 else 0
        j, m = i - 1, m - 1
    return sorted(caps)


def autotune_audio_buckets(lengths_samples: Sequence[int], k: int,
                           sample_rate: int) -> Tuple[float, ...]:
    """Caps in seconds for DataConfig.audio_buckets, rounded UP to 10 ms
    (rounding up can only add padding, never truncate; 10 ms keeps caps
    human-readable and is half the 20 ms wav2vec2 frame stride)."""
    caps = optimal_buckets(lengths_samples, k)
    # integer ceil to centiseconds (float ceil of c/sr*100 can overshoot a
    # whole 10 ms on exact multiples: 17600/16000*100 -> 110.00000000000001)
    return tuple((int(c) * 100 + sample_rate - 1) // sample_rate / 100
                 for c in caps)


def bucket_report(lengths: Sequence[int], default_caps: Sequence[int],
                  tuned_caps: Sequence[int]) -> str:
    d = padded_fraction(lengths, default_caps)
    t = padded_fraction(lengths, tuned_caps)
    return (f"bucket autotune: padded fraction {d:.1%} -> {t:.1%} "
            f"({len(tuned_caps)} caps)")


def autotune_from_manifest(manifest: str, dcfg, k: int
                           ) -> Tuple[Tuple[float, ...], str]:
    """Probe `manifest`'s clip durations and return (caps_seconds, report)."""
    from .pipeline import SERDataset  # lazy: pipeline imports this module
    ds = SERDataset(manifest, dcfg)
    lengths = [ds.audio_length(i) for i in range(len(ds))]
    sr = dcfg.sample_rate
    caps = autotune_audio_buckets(lengths, k, sr)
    report = bucket_report(
        lengths, [seconds_to_samples(b, sr) for b in dcfg.audio_buckets],
        [seconds_to_samples(c, sr) for c in caps])
    return caps, report
