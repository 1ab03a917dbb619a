"""w2v-BERT 2.0, the speech encoder of SeamlessM4T v2
(facebook/w2v-bert-2.0; Hugging Face's `Wav2Vec2BertModel` and
`SeamlessM4TFeatureExtractor`), selected by `Wav2Vec2Config.is_conformer`.
The JAX package has no counterpart.

The input is not the waveform but its Kaldi-style log-mel fbank, computed
here on the device in float32 (`fbank`): the wave x 2^15, 400-sample
povey-window frames at hop 160 without centring, each frame's DC offset
removed and pre-emphasis 0.97, a 512-point power spectrum, 80 Kaldi-mel
triangles over 20-8000 Hz, the natural log floored at 1.1920929e-07, each
mel bin normalised over the clip's own valid frames (variance with ddof
1), padded frames zero, and frames (2k, 2k + 1) stacked to 160 dims at
50 Hz; stacked frame k is valid where frame 2k + 1 is. A padded clip thus
gets the features it would get alone.

Then (`conformer`): LN(160), Linear 160 -> hidden, padded frames zeroed,
and the conformer layers, each
    x = x + 0.5 * FFN1(LN(x))
    x = x + MHSA(LN(x))         q.k/sqrt(D) + q.E[clamp(j - i, -l, r) + l]/sqrt(D)
    x = x + ConvModule(x)       LN, padded frames zeroed, pointwise C -> 2C,
                                GLU, causal depthwise conv (left pad K - 1),
                                LN, swish, pointwise C -> C (no biases)
    x = LN(x + 0.5 * FFN2(LN(x)))
with FFN = Linear, swish, Linear. The relative-key term is computed as
q @ E^T [B, H, S, l + r + 1] and gathered by the clamped distance, which
gives the dot products of Hugging Face's [S, S, D] einsum.

Precision (the port's contract, as layers.encoder_stack's): products,
biases, residuals and activations in the compute dtype; the fbank, every
norm's moments, the attention logits and softmax in float32, cast back.

Layout: per-layer leaves stacked [L, ...]; linear kernels [in, out]; the
depthwise taps [K, C] under `kernel` (a product's scale 1/sqrt(K) by the
benchmark's weight rule); the distance embedding [L, l + r + 1, D] under
`rel_attn_embed`. `ops/quant.quantize_backbones` quantises the products
(q/k/v/out, the FFNs, the pointwise convs) and leaves the depthwise taps
(`depthwise`) and the embedding float.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CONFORMER, Wav2Vec2Config
from ..utils import profiling
from ..utils.runtime import export_safe_cache
from . import layers, remat as remat_lib
from .wav2vec2 import _spec_augment

Tensor = torch.Tensor

SAMPLE_RATE = 16000
FRAME, HOP, N_FFT = 400, 160, 512
NUM_MEL_BINS, STRIDE = 80, 2          # fbank frames stacked STRIDE to a position
FEATURE_DIM = NUM_MEL_BINS * STRIDE   # the feature projection's input width
PREEMPHASIS = 0.97
MEL_LOW, MEL_HIGH = 20.0, 8000.0
MEL_FLOOR = 1.192092955078125e-07
NORM_EPS = 1e-7


# ------------------------------------------------------------------ fbank

def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_filters() -> np.ndarray:
    """[N_FFT // 2 + 1, NUM_MEL_BINS] Kaldi-mel triangles over 20-8000 Hz,
    triangular in mel, unnormalised (transformers' mel_filter_bank with
    mel_scale="kaldi", triangularize_in_mel_space=True), float64."""
    mels = np.linspace(_kaldi_mel(MEL_LOW), _kaldi_mel(MEL_HIGH), NUM_MEL_BINS + 2)
    bins = _kaldi_mel(SAMPLE_RATE / N_FFT * np.arange(N_FFT // 2 + 1))
    slopes = mels[None, :] - bins[:, None]
    diff = np.diff(mels)
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def povey_window() -> np.ndarray:
    """Kaldi's povey window of FRAME samples: a symmetric Hann to the 0.85."""
    return np.power(np.hanning(FRAME), 0.85)


@export_safe_cache(maxsize=8)
def _fbank_constants(device: torch.device) -> Tuple[Tensor, Tensor]:
    """(window [FRAME], mel bank [N_FFT // 2 + 1, NUM_MEL_BINS]) in float32
    on `device`, copied there once a process."""
    return (torch.from_numpy(povey_window().astype(np.float32)).to(device),
            torch.from_numpy(mel_filters().astype(np.float32)).to(device))


def fbank(wave: Tensor, sample_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """wave [B, T] (any float dtype) and its sample mask -> (stacked
    features [B, S, FEATURE_DIM] float32, frame mask [B, S] float32), on
    the wave's device and with no host read. S = F // STRIDE for F = (T -
    400) // 160 + 1 frames of the padded batch."""
    with profiling.span("audio_encoder.fbank"):
        window, mels = _fbank_constants(wave.device)
        x = wave.float() * 32768.0
        frames = x.unfold(-1, FRAME, HOP)                                   # [B, F, 400]
        frames = frames - frames.mean(-1, keepdim=True)
        frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                            frames[..., 1:] - PREEMPHASIS * frames[..., :-1]], -1)
        spec = torch.fft.rfft(frames * window, n=N_FFT)
        power = spec.real.square() + spec.imag.square()
        logmel = torch.log(torch.clamp(power @ mels, min=MEL_FLOOR))       # [B, F, M]

        B, n_frames, _ = logmel.shape
        samples = sample_mask.to(torch.int32).sum(-1)
        valid_frames = torch.clamp((samples - FRAME) // HOP + 1, min=0)
        valid = (torch.arange(n_frames, device=wave.device)[None, :]
                 < valid_frames[:, None]).float()                          # [B, F]
        m = valid[..., None]
        n = m.sum(1, keepdim=True)
        mean = (logmel * m).sum(1, keepdim=True) / n.clamp(min=1.0)
        var = ((logmel - mean).square() * m).sum(1, keepdim=True) / (n - 1.0).clamp(min=1.0)
        feats = (logmel - mean) * torch.rsqrt(var + NORM_EPS) * m

        S = n_frames // STRIDE
        feats = feats[:, :S * STRIDE].reshape(B, S, FEATURE_DIM)
        return feats, valid[:, STRIDE - 1:S * STRIDE:STRIDE]


# ------------------------------------------------------------------- init

def init_w2v_bert(init: layers.Init, cfg: Wav2Vec2Config) -> dict:
    """Hugging Face's init distributions: normal(0, 0.02) linears with zero
    biases, kaiming-normal convs without biases, unit LNs, the distance
    embedding N(0, 1), the feature projection uniform(+-1/sqrt(in))."""
    h, f, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    K, R = cfg.conv_depthwise_kernel_size, (cfg.left_max_position_embeddings
                                            + cfg.right_max_position_embeddings + 1)
    L = (cfg.num_hidden_layers,)
    lin = lambda i, o: layers.init_normal_linear(init, i, o, 0.02, stack=L)
    ln = lambda: layers.init_layer_norm(init, h, stack=L)
    stacked = {
        "ffn1_ln": ln(), "ffn1_in": lin(h, f), "ffn1_out": lin(f, h),
        "attn_ln": ln(), "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
        "rel_attn_embed": init.normal((*L, R, h // H), 1.0),
        "conv_ln": ln(),
        "pointwise_in": {"kernel": init.normal((*L, h, 2 * h), math.sqrt(2.0 / h))},
        "depthwise": {"kernel": init.normal((*L, K, h), math.sqrt(2.0 / K))},
        "depthwise_ln": ln(),
        "pointwise_out": {"kernel": init.normal((*L, h, h), math.sqrt(2.0 / h))},
        "ffn2_ln": ln(), "ffn2_in": lin(h, f), "ffn2_out": lin(f, h),
        "final_ln": ln(),
    }
    d_in = FEATURE_DIM
    bound = 1.0 / math.sqrt(d_in)
    return {
        "feat_proj": {"ln": layers.init_layer_norm(init, d_in),
                      "proj": {"kernel": init.uniform((d_in, h), bound),
                               "bias": init.uniform((h,), bound)}},
        "layers": stacked,
        "masked_spec_embed": init.uniform((h,), 1.0).abs(),  # U[0, 1)
    }


# ---------------------------------------------------------------- encoder

@export_safe_cache(maxsize=16)
def distance_index(S: int, left: int, right: int, device: torch.device) -> Tensor:
    """[S, S] int64 row of the distance embedding for query i and key j,
    clamp(j - i, -left, right) + left, made on `device` once a length."""
    pos = torch.arange(S, device=device)
    return torch.clamp(pos[None, :] - pos[:, None], -left, right) + left


def self_attention(layer: dict, cfg: Wav2Vec2Config, x: Tensor, key_bias: Tensor,
                   index: Tensor, generator: Optional[torch.Generator],
                   deterministic: bool) -> Tensor:
    """Relative-key self-attention of x [B, S, E] (the LN's output):
    logits (q.k + q.E[index]) / sqrt(D) + key_bias in float32."""
    with profiling.span("conformer.attention"):
        B, S, E = x.shape
        H = cfg.num_attention_heads
        D = E // H
        q = layers.linear(layer["q"], x).reshape(B, S, H, D)
        k = layers.linear(layer["k"], x).reshape(B, S, H, D)
        v = layers.linear(layer["v"], x).reshape(B, S, H, D)
        content = torch.einsum("bqhd,bkhd->bhqk", q, k)
        rel = torch.einsum("bqhd,rd->bhqr", q, layer["rel_attn_embed"].to(x.dtype))
        rel = torch.gather(rel, -1, index.expand(B, H, S, S))
        logits = (content.float() + rel.float()) / math.sqrt(D) + key_bias
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = layers.dropout(generator, attn, cfg.attention_dropout, deterministic)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, E)
        return layers.linear(layer["out"], ctx)


def conv_module(layer: dict, cfg: Wav2Vec2Config, x: Tensor, frame_mask: Tensor,
                generator: Optional[torch.Generator], deterministic: bool) -> Tensor:
    """The conformer's convolution module on x [B, S, C]: LN, padded frames
    zeroed, pointwise C -> 2C, GLU, the causal depthwise conv (K taps, left
    pad K - 1), LN, the activation, pointwise C -> C."""
    with profiling.span("conformer.conv_module"):
        eps = cfg.layer_norm_eps
        y = layers.layer_norm(layer["conv_ln"], x, eps=eps) * frame_mask[..., None]
        y = F.glu(layers.linear(layer["pointwise_in"], y), dim=-1)
        taps = layer["depthwise"]["kernel"]                                 # [K, C]
        y = F.pad(y.transpose(1, 2), (taps.shape[0] - 1, 0))
        y = layers.conv1d({"kernel": taps.t()[:, None, :]}, y, 1, groups=y.shape[1])
        y = layers.layer_norm(layer["depthwise_ln"], y.transpose(1, 2), eps=eps)
        y = layers.linear(layer["pointwise_out"], F.silu(y))
        return layers.dropout(generator, y, cfg.hidden_dropout, deterministic)


def _ffn(layer: dict, name: str, cfg: Wav2Vec2Config, x: Tensor,
         generator: Optional[torch.Generator], deterministic: bool) -> Tensor:
    f = F.silu(layers.linear(layer[f"{name}_in"], x))
    f = layers.dropout(generator, f, cfg.activation_dropout, deterministic)
    return layers.dropout(generator, layers.linear(layer[f"{name}_out"], f),
                          cfg.hidden_dropout, deterministic)


def conformer(params: dict, cfg: Wav2Vec2Config, feats: Tensor, frame_mask: Tensor, *,
              deterministic: bool = True, generator: Optional[torch.Generator] = None,
              spec_augment: bool = False, remat: remat_lib.RematSpec = False) -> Tensor:
    """The feature projection and the conformer layers: feats [B, S, FEATURE_DIM]
    and frame_mask [B, S], both in the compute dtype -> [B, S, hidden]."""
    with profiling.span("audio_encoder.conformer"):
        B, S, _ = feats.shape
        profiling.count("conformer.frames", B * S)
        eps = cfg.layer_norm_eps
        h = layers.linear(params["feat_proj"]["proj"],
                          layers.layer_norm(params["feat_proj"]["ln"], feats, eps=eps))
        if spec_augment and not deterministic and cfg.apply_spec_augment:
            h = _spec_augment(generator, cfg, h, frame_mask, params["masked_spec_embed"])
        h = layers.dropout(generator, h * frame_mask[..., None], cfg.hidden_dropout,
                           deterministic)
        key_bias = layers.key_mask_bias(frame_mask)
        index = distance_index(S, cfg.left_max_position_embeddings,
                               cfg.right_max_position_embeddings, feats.device)

        def body(h: Tensor, layer: dict, g: Optional[torch.Generator]) -> Tensor:
            drop = (g, deterministic)
            ln = lambda name, x: layers.layer_norm(layer[name], x, eps=eps)
            h = h + 0.5 * _ffn(layer, "ffn1", cfg, ln("ffn1_ln", h), *drop)
            a = self_attention(layer, cfg, ln("attn_ln", h), key_bias, index, *drop)
            h = h + layers.dropout(g, a, cfg.attention_dropout, deterministic)
            h = h + conv_module(layer, cfg, h, frame_mask, *drop)
            h = h + 0.5 * _ffn(layer, "ffn2", cfg, ln("ffn2_ln", h), *drop)
            return ln("final_ln", h)

        run = remat_lib.apply_remat(body, remat)
        for i in range(params["layers"]["final_ln"]["scale"].shape[0]):
            h = run(h, layers.layer_at(params["layers"], i), generator)
        return h


def w2v_bert_encode(params: dict, cfg: Wav2Vec2Config, wave: Tensor, sample_mask: Tensor, *,
                    deterministic: bool = True, generator: Optional[torch.Generator] = None,
                    spec_augment: bool = False, remat: remat_lib.RematSpec = False,
                    tp=None) -> Tuple[Tensor, Tensor]:
    """wave [B, T] 16 kHz audio in the compute dtype, sample_mask [B, T]
    (1 valid) -> (hidden [B, S, hidden], frame_mask [B, S]) in the compute
    dtype, as wav2vec2.wav2vec2_encode returns them. Training draws
    SpecAugment (where `spec_augment` and the config ask for it) and
    dropout from `generator`: the encoder's input, attention weights and
    output, the FFNs' activation and output, and the conv module's output."""
    if tp is not None:
        raise NotImplementedError(
            f"w2v-BERT 2.0 (backbone={CONFORMER!r}) has no tensor-parallel forward")
    feats, frame_mask = fbank(wave, sample_mask)
    frame_mask = frame_mask.to(wave.dtype)
    h = conformer(params, cfg, feats.to(wave.dtype), frame_mask, deterministic=deterministic,
                  generator=generator, spec_augment=spec_augment, remat=remat)
    return h, frame_mask
