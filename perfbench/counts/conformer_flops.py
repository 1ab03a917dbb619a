"""Analytic operation counts of the model with w2v-BERT 2.0 as its audio
encoder (perfbench/configs/w2v_bert.json): matmul and convolution terms
only, 2 FLOPs a multiply-add, as `flops.py` counts the others.

The audio side of one clip of `samples` samples: F = (samples - 400) //
160 + 1 fbank frames and S = F // STRIDE positions;
  - the fbank's mel product, 2 F (n_fft / 2 + 1) M (its FFT is no product);
  - the feature projection, 2 S (M STRIDE) h;
  - each conformer layer: the two FFNs 2 x 2 x 2 S h f, q/k/v/out 4 x 2 S h^2,
    the pointwise convs 2 S h 2h + 2 S h h, the attention's q.k and p.v
    2 x 2 S^2 h, the relative-key product q @ E^T 2 S R h (R = l + r + 1
    distances), the depthwise conv 2 S h K.
The adapter, the cross-modal attention, the pooling, fusion, classifier
and XLM-R terms are `flops.utt_flops_parts`'s, taken at S frames: it is
called on a configuration whose conv stack is one 1-tap conv of stride 1,
so that it sees S samples as S frames; only its terms past the audio
encoder are read.
"""

from __future__ import annotations

from typing import Dict

from . import flops

FRAME, HOP, N_FFT = 400, 160, 512
NUM_MEL_BINS, STRIDE = 80, 2   # M mel bins, frames stacked to a position


def positions(samples: int) -> int:
    return max(0, (samples - FRAME) // HOP + 1) // STRIDE


def conformer_parts(cfg: dict, samples: int) -> Dict[str, float]:
    """FLOPs of the audio encoder on one clip of `samples` samples, by part."""
    a = cfg["audio"]
    n_frames = max(0, (samples - FRAME) // HOP + 1)
    S = n_frames // STRIDE
    h, f, L = a["hidden_size"], a["intermediate_size"], a["num_hidden_layers"]
    R = a["left_max_position_embeddings"] + a["right_max_position_embeddings"] + 1
    K = a["conv_depthwise_kernel_size"]
    return {
        "fbank": 2.0 * n_frames * (N_FFT // 2 + 1) * NUM_MEL_BINS,
        "feat_proj": 2.0 * S * NUM_MEL_BINS * STRIDE * h,
        "ffn": L * 2 * 2 * 2.0 * S * h * f,
        "qkvo": L * 4 * 2.0 * S * h * h,
        "pointwise": L * (2.0 * S * h * 2 * h + 2.0 * S * h * h),
        "attention": L * 2 * 2.0 * S * S * h,
        "relative_key": L * 2.0 * S * R * h,
        "depthwise": L * 2.0 * S * h * K,
        "frames": float(S),
    }


def other_parts(cfg: dict, samples: int, text_tokens: int) -> Dict[str, float]:
    """`flops.utt_flops_parts` at the conformer's S frames (its audio
    encoder's terms are not the conformer's and are not read)."""
    S = positions(samples)
    frames_as_samples = {**cfg, "audio": {**cfg["audio"], "conv_dim": [1], "conv_kernel": [1],
                                          "conv_stride": [1]}}
    return flops.utt_flops_parts(frames_as_samples, S, text_tokens)


def step_flops(cfg: dict, *, audio_rows: int, text_rows: int, samples: int,
               text_tokens: int) -> float:
    """FLOPs of one step over `audio_rows` padded rows of `samples` samples
    whose text side encodes `text_rows` rows of `text_tokens` tokens."""
    audio = conformer_parts(cfg, samples)
    p = other_parts(cfg, samples, text_tokens)
    per_audio_row = (sum(v for k, v in audio.items() if k != "frames") + p["audio_adapter"]
                     + p["cross"] + p["pool"] + p["fusion"] + p["classifier"])
    per_text_row = p["text_transformer"] + p["text_adapter"]
    return per_audio_row * audio_rows + per_text_row * text_rows
