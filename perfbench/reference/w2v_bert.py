"""Plain reference of the model with w2v-BERT 2.0 as its audio encoder
(facebook/w2v-bert-2.0): the SeamlessM4T log-mel fbank and the conformer
stack, then everything else as `model.py` has it (the front-end DSP,
XLM-R, the adapters, the feature fusion, the heads and the classifier).

Written from transformers 4.57.6's `SeamlessM4TFeatureExtractor`
(feature_extraction_seamless_m4t.py with audio_utils.spectrogram) and
`Wav2Vec2BertModel` (modeling_wav2vec2_bert.py) without an adapter, in the
layout of the port's parameter tree (kernels [in, out]; the pointwise
convs' kernels [C, 2C] and [C, C]; the depthwise taps [K, C]; each
layer's distance embedding [L, l + r + 1, D] as `rel_attn_embed`). The
relative-key term is Hugging Face's: the embedding gathered to
[S, S, D] by the clamped distance and an einsum with q. It imports
nothing of the port, of JAX or of transformers.

The fbank: the wave (as the encoder receives it, in the compute dtype)
in float32, x 2^15; 400-sample povey-window frames at hop 160, no
centring; each frame's DC offset removed, pre-emphasis 0.97; a 512-point
power spectrum; 80 Kaldi-mel triangles over 20-8000 Hz (triangular in
mel, unnormalised); the log floored at 1.1920929e-07; each mel bin
normalised by the mean and ddof-1 variance over the clip's own frames;
frames (2k, 2k + 1) stacked, valid where frame 2k + 1 is. The extractor
computes each clip alone; here the batch's frames are computed at once
and each clip's statistics taken over its valid frames only, which gives
each clip its own numbers.

Precision, as `model.py` states it: the fbank in float32 whatever the
configuration, then cast to the compute dtype; products, biases,
residuals, GLU and swish in the compute dtype; each LayerNorm's moments
in float32, the result cast back; the attention's two score products
(q.k and q.E) each rounded to the compute dtype, then summed, scaled by
1/sqrt(D) and masked in float32, the softmax in float32 and cast back. On
the CPU a bfloat16 convolution is the float32 one of the bfloat16
operands, rounded (`model._conv`). Every product with a kernel goes through
`model.linear`, looked up at each call (perfbench/control.py --epilogue
replaces it).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp, model as base
from .model import (_adapter, _conv, _feature_fuse, _feature_proj, _gelu_mode, compute_dtype,
                    heads, layer_at, layer_norm, served_weights, text_encoder)

Tensor = torch.Tensor

NUM_MEL_BINS, STRIDE = 80, 2   # SeamlessM4TFeatureExtractor's defaults


# ------------------------------------------------------------------ fbank

def _mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def kaldi_mel_bank(num_mel_bins: int, n_fft: int = 512, sample_rate: int = 16000):
    """[n_fft // 2 + 1, num_mel_bins]: audio_utils.mel_filter_bank(257,
    80, 20, 8000, 16000, norm=None, mel_scale="kaldi",
    triangularize_in_mel_space=True)."""
    edges = np.linspace(_mel(20.0), _mel(sample_rate // 2), num_mel_bins + 2)
    fft_mel = _mel(sample_rate / n_fft * np.arange(n_fft // 2 + 1))
    bank = np.zeros((n_fft // 2 + 1, num_mel_bins))
    for m in range(num_mel_bins):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (fft_mel - lo) / (mid - lo)
        fall = (hi - fft_mel) / (hi - mid)
        bank[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return bank


def fbank(wave: Tensor, mask: Tensor):
    """wave [B, T] -> (features [B, S, 80 * 2], frame mask [B, S]),
    float32."""
    device = wave.device
    frame, hop, n_fft = 400, 160, 512
    window = torch.tensor(np.hanning(frame) ** 0.85, dtype=torch.float32, device=device)
    bank = torch.tensor(kaldi_mel_bank(NUM_MEL_BINS), dtype=torch.float32, device=device)
    x = wave.float() * 2.0 ** 15
    frames = x.unfold(1, frame, hop)
    frames = frames - frames.mean(2, keepdim=True)
    emphasised = frames[:, :, 1:] - 0.97 * frames[:, :, :-1]
    frames = torch.cat([frames[:, :, :1] * (1.0 - 0.97), emphasised], 2)
    spectrum = torch.fft.rfft(frames * window, n=n_fft)
    power = spectrum.real.square() + spectrum.imag.square()
    logmel = torch.log(torch.clamp(power @ bank, min=1.192092955078125e-07))

    B, n_frames, M = logmel.shape
    lengths = mask.to(torch.int32).sum(1)
    valid_frames = torch.clamp((lengths - frame) // hop + 1, min=0)
    valid = (torch.arange(n_frames, device=device)[None, :] < valid_frames[:, None]).float()
    w = valid[:, :, None]
    count = w.sum(1, keepdim=True)
    mean = (logmel * w).sum(1, keepdim=True) / count.clamp(min=1.0)
    var = ((logmel - mean).square() * w).sum(1, keepdim=True) / (count - 1.0).clamp(min=1.0)
    feats = (logmel - mean) * torch.rsqrt(var + 1e-7) * w

    S = n_frames // STRIDE
    stacked = feats[:, :S * STRIDE].reshape(B, S, STRIDE * M)
    return stacked, valid[:, :S * STRIDE].reshape(B, S, STRIDE)[:, :, -1]


# ---------------------------------------------------------- the conformer

def relative_key_scores(q: Tensor, embed: Tensor, S: int, left: int, right: int) -> Tensor:
    """Hugging Face's relative_key term before its 1/sqrt(D): q [B, H, S, D]
    against the distance embedding gathered to [S, S, D], [B, H, S, S]."""
    pos = torch.arange(S, device=q.device)
    distance = torch.clamp(pos[None, :] - pos[:, None], -left, right)
    positional = embed[distance + left].to(q.dtype)
    return torch.einsum("bhld,lrd->bhlr", q, positional)


def causal_depthwise(x: Tensor, taps: Tensor) -> Tensor:
    """x [B, C, S] padded on the left by K - 1, then the depthwise conv with
    taps [K, C], no bias."""
    K = taps.shape[0]
    return _conv({"kernel": taps.t()[:, None, :]}, F.pad(x, (K - 1, 0)), 1,
                 groups=x.shape[1])


def _swish(x: Tensor) -> Tensor:
    return F.silu(x)


def _feed_forward(layer: dict, name: str, x: Tensor) -> Tensor:
    return base.linear(layer[f"{name}_out"], _swish(base.linear(layer[f"{name}_in"], x)))


def _self_attention(layer: dict, a: dict, x: Tensor, key_mask: Tensor) -> Tensor:
    B, S, E = x.shape
    H = a["num_attention_heads"]
    D = E // H
    q = base.linear(layer["q"], x).view(B, S, H, D).transpose(1, 2)
    k = base.linear(layer["k"], x).view(B, S, H, D).transpose(1, 2)
    v = base.linear(layer["v"], x).view(B, S, H, D).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-2, -1))
    rel = relative_key_scores(q, layer["rel_attn_embed"], S, a["left_max_position_embeddings"],
                              a["right_max_position_embeddings"])
    logits = (scores.float() + rel.float()) / math.sqrt(D)
    logits = logits.masked_fill((key_mask == 0)[:, None, None, :], -math.inf)
    probs = torch.softmax(logits, -1).to(x.dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, E)
    return base.linear(layer["out"], ctx)


def _conv_module(layer: dict, a: dict, x: Tensor, mask: Tensor) -> Tensor:
    eps = a["layer_norm_eps"]
    h = layer_norm(layer["conv_ln"], x, eps)
    h = h.masked_fill((mask == 0)[:, :, None], 0.0)
    h = base.linear(layer["pointwise_in"], h).transpose(1, 2)        # [B, 2C, S]
    h = F.glu(h, dim=1)
    h = causal_depthwise(h, layer["depthwise"]["kernel"])
    h = layer_norm(layer["depthwise_ln"], h.transpose(1, 2), eps)
    return base.linear(layer["pointwise_out"], _swish(h))


def conformer_layer(layer: dict, a: dict, h: Tensor, mask: Tensor) -> Tensor:
    eps = a["layer_norm_eps"]
    h = _feed_forward(layer, "ffn1", layer_norm(layer["ffn1_ln"], h, eps)) * 0.5 + h
    h = _self_attention(layer, a, layer_norm(layer["attn_ln"], h, eps), mask) + h
    h = h + _conv_module(layer, a, h, mask)
    h = _feed_forward(layer, "ffn2", layer_norm(layer["ffn2_ln"], h, eps)) * 0.5 + h
    return layer_norm(layer["final_ln"], h, eps)


def audio_encoder(p: dict, a: dict, wave: Tensor, mask: Tensor):
    """wave [B, T] in the compute dtype -> (hidden [B, S, H], frame mask
    [B, S] in the compute dtype)."""
    dt = wave.dtype
    feats, frame_mask = fbank(wave, mask)
    feats, frame_mask = feats.to(dt), frame_mask.to(dt)
    h = base.linear(p["feat_proj"]["proj"], layer_norm(p["feat_proj"]["ln"], feats,
                                                  a["layer_norm_eps"]))
    h = h * frame_mask[..., None]
    for i in range(p["layers"]["final_ln"]["scale"].shape[0]):
        h = conformer_layer(layer_at(p["layers"], i), a, h, frame_mask)
    return h, frame_mask


# ----------------------------------------------------------------- forward

def encode(w: dict, cfg: dict, wave: Tensor, mask: Tensor, text_ids: Tensor,
           text_mask: Tensor, *, text_tile: int = 1):
    """A copy of `model.encode` with the audio encoder swapped: the front
    end, both encoders and the feature fusion, on served weights `w`."""
    m, a, t = cfg["model"], cfg["audio"], cfg["text"]
    gelu = _gelu_mode(cfg)
    q = c = None
    if m["frontend_dsp"] and (m["use_quality_gates"] or m["use_audio_conditioning"]):
        wave, q, c = dsp.frontend(wave, mask, sample_rate=16000,
                                  use_gates=m["use_quality_gates"],
                                  use_conditioning=m["use_audio_conditioning"],
                                  zero_non_accept=m["zero_non_accept"])
    dt = compute_dtype(cfg)
    seq, frame_mask = audio_encoder(w["audio_backbone"], a, wave.to(dt), mask)
    seq = _adapter(w["audio_adapter"], seq)
    uq, uc = m["use_quality_gates"], m["use_audio_conditioning"]
    if uq or uc:
        B = seq.shape[0]
        q = (q if q is not None else seq.new_zeros((B, 8))).to(dt)
        c = (c if c is not None else seq.new_zeros((B, 12))).to(dt)
        if uq:
            q = _feature_proj(w["quality_proj"], q)
        if uc:
            c = _feature_proj(w["cond_proj"], c)
        if uq and uc:
            seq = _feature_fuse(w["combined_fusion"], seq, torch.cat([q, c], -1))
        elif uq:
            seq = _feature_fuse(w["quality_fusion"], seq, q)
        else:
            seq = _feature_fuse(w["conditioning_fusion"], seq, c)
    t_seq = _adapter(w["text_adapter"], text_encoder(w["text_backbone"], t, text_ids,
                                                     text_mask, gelu))
    if text_tile > 1:
        t_seq = torch.cat([t_seq] * text_tile, 0)
        text_mask = torch.cat([text_mask] * text_tile, 0)
    return seq, frame_mask, t_seq, text_mask


def forward(weights: dict, cfg: dict, batch: dict, *, use_openmax: bool = True):
    """The eval forward on one batch (audio [B, T], audio_mask, text_ids
    [B, S], text_mask): (logits [B, C], uncertainty [B, 1])."""
    w = served_weights(weights, cfg["model"]["compute_dtype"])
    enc = encode(w, cfg, batch["audio"].float(), batch["audio_mask"].float(),
                 batch["text_ids"], batch["text_mask"].float())
    return heads(w, cfg, *enc, use_openmax=use_openmax)
