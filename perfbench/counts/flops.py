"""Analytic operation counts of the model's forward and of kernel A1.

`model_gflops_per_utt` is a frozen copy of the port's
`eval/benchmark.py:model_gflops_per_utt` (itself the JAX package's
`eval/benchmark.py`), reading the benchmark's configuration file instead
of the port's dataclasses: matmul and convolution terms only, 2 FLOPs a
multiply-add. `step_flops` extends it to the rows a step really runs: the
audio side and the heads on every audio row (a TTA step's V views), the
text side on the text rows it encodes (once per clip under TTA).

`a1_flops` and `a1_bytes` count kernel A1 (`csrc/residual_stack.cu`, the
classifier's L residual layers on [B, D] in float32) as PERF.md's table of
kernels does: two [B, D] x [D, D] products a layer; each weight, bias and
norm vector read once, x read and the output written once.
"""

from __future__ import annotations

from typing import Dict

from . import peaks


def utt_flops_parts(cfg: dict, samples: int, text_tokens: int) -> Dict[str, float]:
    """FLOPs of one utterance of `samples` audio samples and `text_tokens`
    tokens, by part."""
    a, x, m = cfg["audio"], cfg["text"], cfg["model"]
    conv, t, c_in = 0.0, samples, 1
    for c_out, k, s in zip(a["conv_dim"], a["conv_kernel"], a["conv_stride"]):
        t = (t - k) // s + 1
        conv += 2.0 * t * c_in * c_out * k
        c_in = c_out
    S = t

    def transformer(s, h, inter, layers):
        return layers * (4 * 2.0 * s * h * h + 4.0 * s * s * h + 2 * 2.0 * s * h * inter)

    ha, hx = a["hidden_size"], x["hidden_size"]
    pos_conv = 2.0 * S * (ha // a["num_conv_pos_embedding_groups"]) * ha \
        * a["num_conv_pos_embeddings"]
    sh, ad, pd, bd = m["shared_dim"], m["adapter_dim"], m["proj_dim"], m["classifier_base_dim"]
    T_ = text_tokens
    cross = 2.0 * (S * (ha * sh * 2 + hx * sh) + T_ * (hx * sh * 2 + ha * sh)) \
        + 4.0 * S * T_ * sh * 2 + 2.0 * (S * sh * ha + T_ * sh * hx)
    return {
        "conv": conv,
        "pos_conv": pos_conv,
        "audio_transformer": transformer(S, ha, a["intermediate_size"], a["num_hidden_layers"]),
        "text_transformer": transformer(T_, hx, x["intermediate_size"], x["num_hidden_layers"]),
        "cross": cross,
        "audio_adapter": 2.0 * 2 * S * ha * ad,
        "text_adapter": 2.0 * 2 * T_ * hx * ad,
        "pool": 2.0 * (S * (ha * 128 + 128) + T_ * (hx * 128 + 128)),
        "fusion": 2.0 * (2 * ha * pd + 2 * hx * pd + 2 * pd * pd + 2 * pd * max(32, pd // 2)),
        "classifier": 2.0 * (pd * bd + m["classifier_layers"] * 2 * bd * bd
                             + bd * (bd // 2) + (bd // 2) * m["num_labels"]),
        "frames": float(S),
    }


def model_gflops_per_utt(cfg: dict, *, audio_seconds: float = 4.0, text_tokens: int = 32,
                         sample_rate: int = 16000) -> Dict[str, float]:
    """The port's breakdown, under its keys."""
    p = utt_flops_parts(cfg, int(audio_seconds * sample_rate), text_tokens)
    heads = (p["cross"] + p["audio_adapter"] + p["text_adapter"] + p["pool"]
             + p["fusion"] + p["classifier"])
    total = (p["conv"] + p["pos_conv"] + p["audio_transformer"]
             + p["text_transformer"] + heads)
    return {"total_gflops": total / 1e9,
            "conv_extractor_gflops": p["conv"] / 1e9,
            "audio_transformer_gflops": (p["audio_transformer"] + p["pos_conv"]) / 1e9,
            "text_transformer_gflops": p["text_transformer"] / 1e9,
            "heads_gflops": heads / 1e9,
            "audio_frames": p["frames"]}


def step_flops(cfg: dict, *, audio_rows: int, text_rows: int, samples: int,
               text_tokens: int) -> float:
    """FLOPs of one step over `audio_rows` padded rows of `samples` samples
    whose text side encodes `text_rows` rows of `text_tokens` tokens."""
    p = utt_flops_parts(cfg, samples, text_tokens)
    per_audio_row = (p["conv"] + p["pos_conv"] + p["audio_transformer"] + p["audio_adapter"]
                     + p["cross"] + p["pool"] + p["fusion"] + p["classifier"])
    per_text_row = p["text_transformer"] + p["text_adapter"]
    return per_audio_row * audio_rows + per_text_row * text_rows


def a1_flops(rows: int, layers: int, width: int) -> float:
    return 2.0 * 2 * rows * width * width * layers


def a1_bytes(rows: int, layers: int, width: int) -> float:
    weights = layers * (2 * width * width + 2 * width + 4 * width)
    return 4.0 * (weights + 2 * rows * width)


def a1_least_seconds(rows: int, layers: int, width: int) -> float:
    """The larger of A1's float32 operations over the CUDA cores' peak and
    its bytes over HBM's."""
    return max(a1_flops(rows, layers, width) / peaks.FP32_FLOPS,
               a1_bytes(rows, layers, width) / peaks.HBM_BYTES_PER_S)
