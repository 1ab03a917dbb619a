"""Whisper: the encoder-decoder ASR model with a KV-cached greedy decode.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/whisper.py, with its parameter tree and arithmetic, in the
geometry of transformers' `WhisperForConditionalGeneration`:

  * log-mel: n_fft 400, hop 160, 80-128 Slaney-scale Slaney-normalised mel
    filters, log10 clamped to max - 8, (x + 4) / 4 (WhisperFeatureExtractor's
    recipe), batched on the device of the wave;
  * encoder: conv(k3, s1) -> GELU -> conv(k3, s2) -> GELU, fixed sinusoidal
    positions, pre-LN layers, final LN; GELU is the exact erf form at every
    dtype;
  * decoder: tied token embedding, learned positions, pre-LN blocks of
    causal self-attention over a KV cache, cross-attention and FFN, final
    LN, logits = x @ embed_tokens.T in f32;
  * attention: q/v/out have biases, k has none;
  * greedy decode: `max_new_tokens` steps whatever the tokens, a row
    frozen at EOS (it repeats EOS with confidence 1), the per-step max
    softmax probability returned as the token's confidence.

The decode reads nothing back to the host: every row is at the same step,
so the cache is written at a Python index and the causal mask built from
it, and `finished` and the EOS substitution stay on the device.

Layout: linear kernels [in, out] and layers stacked [L, ...] as the JAX
package's; the conv kernels are torch's [C_out, C_in, K] (JAX's WIO
[K, C_in, C_out] transposed, weights.whisper_params_from_jax). The layers
are counted from their layer norms, which int8 quantisation
(ops/quant.quantize_whisper) leaves alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..frontend import spectral as sp
from . import layers
from .hf_convert import _lin, _ln, _np, _stack, _tensors

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384                    # whisper-tiny
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    layer_norm_eps: float = 1e-5


# --------------------------------------------------------------- log-mel

def _slaney_hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    return np.where(log_region,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                    mel)


def _slaney_mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filter_bank(n_freqs: int = 201, n_mels: int = 80, sample_rate: int = 16000,
                    fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters [n_freqs, n_mels]
    (transformers.audio_utils.mel_filter_bank(norm='slaney',
    mel_scale='slaney'), WhisperFeatureExtractor's bank), built in f64 and
    rounded to f32."""
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_slaney_hz_to_mel(fmin), _slaney_hz_to_mel(fmax), n_mels + 2)
    hz_pts = _slaney_mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - freqs[:, None]           # [n_freqs, n_mels + 2]
    down = -ramps[:, :-2] / fdiff[None, :-1]
    up = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))         # [n_freqs, n_mels]
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_bank(n_freqs: int, n_mels: int, device: torch.device) -> Tensor:
    return torch.from_numpy(mel_filter_bank(n_freqs, n_mels)).to(device)


def log_mel_spectrogram(wave: Tensor, *, n_mels: int = 80, n_fft: int = 400,
                        hop: int = 160) -> Tensor:
    """[B, T] (T typically padded to 30 s = 480000) -> [B, n_mels, T // hop]
    f32: periodic Hann window, centred reflect padding, the final frame
    dropped, power spectrum, Slaney mel, log10 clamped to (row max - 8),
    then (x + 4) / 4."""
    x = sp.reflect_pad(wave.float(), n_fft // 2)
    frames = sp.frame_signal(x, n_fft, hop)[:, :-1]    # drop the last frame
    re, im = sp.framed_rfft(frames * sp.hann_window(n_fft, wave.device))
    power = re * re + im * im                          # [B, F, n_fft // 2 + 1]
    mel = torch.matmul(power, _mel_bank(n_fft // 2 + 1, n_mels, wave.device))
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(1, 2)                    # [B, n_mels, F]


# ------------------------------------------------------------ init/convert

def _init_attn(init: layers.Init, d: int, L: int) -> dict:
    p = {n: layers.init_linear(init, d, d, stack=(L,)) for n in ("q", "k", "v", "out")}
    p["k"] = {"kernel": p["k"]["kernel"]}              # Whisper: k unbiased
    return p


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder positions (openai/whisper audio.py)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper(cfg: WhisperConfig, generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters with the JAX package's init distributions (torch's
    Linear init, uniform conv kernels, N(0, 0.02) embeddings), drawn from
    `generator` on `device` in `dtype`; on the meta device, shapes only."""
    init = layers.Init(generator, device, dtype)
    d = cfg.d_model
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers

    def ffn(L: int, width: int) -> dict:
        return {"ffn_in": layers.init_linear(init, d, width, stack=(L,)),
                "ffn_out": layers.init_linear(init, width, d, stack=(L,))}

    enc_layers = {"attn": _init_attn(init, d, Le),
                  "attn_ln": layers.init_layer_norm(init, d, stack=(Le,)),
                  **ffn(Le, cfg.encoder_ffn_dim),
                  "final_ln": layers.init_layer_norm(init, d, stack=(Le,))}
    dec_layers = {"self_attn": _init_attn(init, d, Ld),
                  "self_ln": layers.init_layer_norm(init, d, stack=(Ld,)),
                  "cross_attn": _init_attn(init, d, Ld),
                  "cross_ln": layers.init_layer_norm(init, d, stack=(Ld,)),
                  **ffn(Ld, cfg.decoder_ffn_dim),
                  "final_ln": layers.init_layer_norm(init, d, stack=(Ld,))}
    pos = torch.as_tensor(_sinusoids(cfg.max_source_positions, d), dtype=dtype,
                          device=init.device)
    return {
        "encoder": {
            "conv1": {"kernel": init.uniform((d, cfg.num_mel_bins, 3),
                                             1.0 / math.sqrt(3 * cfg.num_mel_bins)),
                      "bias": init.zeros((d,))},
            "conv2": {"kernel": init.uniform((d, d, 3), 1.0 / math.sqrt(3 * d)),
                      "bias": init.zeros((d,))},
            "pos": pos,
            "layers": enc_layers,
            "ln": layers.init_layer_norm(init, d),
        },
        "decoder": {
            "embed_tokens": init.normal((cfg.vocab_size, d), 0.02),
            "pos": init.normal((cfg.max_target_positions, d), 0.02),
            "layers": dec_layers,
            "ln": layers.init_layer_norm(init, d),
        },
    }


def _attn_hf(sd: Mapping, prefix: str) -> dict:
    return {n: _lin(sd, f"{prefix}.{m}") for n, m in
            (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj"))}


def params_from_hf(state_dict: Mapping, cfg: WhisperConfig) -> dict:
    """A transformers WhisperModel / WhisperForConditionalGeneration state
    dict (torch tensors or numpy arrays) -> the port's tree, in numpy f32 as
    the JAX package converts it, as f32 CPU tensors (proj_out is tied to
    embed_tokens). transformers is never imported."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def enc_layer(i: int) -> dict:
        p = f"encoder.layers.{i}"
        return {"attn": _attn_hf(sd, f"{p}.self_attn"),
                "attn_ln": _ln(sd, f"{p}.self_attn_layer_norm"),
                "ffn_in": _lin(sd, f"{p}.fc1"), "ffn_out": _lin(sd, f"{p}.fc2"),
                "final_ln": _ln(sd, f"{p}.final_layer_norm")}

    def dec_layer(i: int) -> dict:
        p = f"decoder.layers.{i}"
        return {"self_attn": _attn_hf(sd, f"{p}.self_attn"),
                "self_ln": _ln(sd, f"{p}.self_attn_layer_norm"),
                "cross_attn": _attn_hf(sd, f"{p}.encoder_attn"),
                "cross_ln": _ln(sd, f"{p}.encoder_attn_layer_norm"),
                "ffn_in": _lin(sd, f"{p}.fc1"), "ffn_out": _lin(sd, f"{p}.fc2"),
                "final_ln": _ln(sd, f"{p}.final_layer_norm")}

    conv = lambda name: {"kernel": _np(sd[f"encoder.{name}.weight"]),
                         "bias": _np(sd[f"encoder.{name}.bias"])}
    return _tensors({
        "encoder": {
            "conv1": conv("conv1"), "conv2": conv("conv2"),
            "pos": _np(sd["encoder.embed_positions.weight"]),
            "layers": _stack([enc_layer(i) for i in range(cfg.encoder_layers)]),
            "ln": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": _np(sd["decoder.embed_tokens.weight"]),
            "pos": _np(sd["decoder.embed_positions.weight"]),
            "layers": _stack([dec_layer(i) for i in range(cfg.decoder_layers)]),
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    })


# --------------------------------------------------------------- forward

def _softmax_ctx(s: Tensor, v: Tensor, dtype: torch.dtype) -> Tensor:
    """softmax over the last axis of f32 logits s [B, H, Sq, Sk], cast to
    `dtype`, times v [B, Sk, H, D] -> [B, Sq, H * D]."""
    a = torch.softmax(s, dim=-1).to(dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a, v)
    return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


def _attn(p: dict, x: Tensor, num_heads: int) -> Tensor:
    """Full self-attention of the encoder: the logits scaled by 1/sqrt(Dh)
    after the product, in f32."""
    B, S, E = x.shape
    H = num_heads
    D = E // H
    q = layers.linear(p["q"], x).reshape(B, S, H, D)
    k = layers.linear(p["k"], x).reshape(B, S, H, D)
    v = layers.linear(p["v"], x).reshape(B, S, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    return layers.linear(p["out"], _softmax_ctx(s, v, x.dtype))


def _ffn(layer: dict, x: Tensor) -> Tensor:
    return layers.linear(layer["ffn_out"], F.gelu(layers.linear(layer["ffn_in"], x)))


def encode(params: dict, cfg: WhisperConfig, mel: Tensor) -> Tensor:
    """mel [B, n_mels, frames] -> [B, frames // 2, d_model], in the
    parameters' dtype (the f32 log-mel is cast to it)."""
    enc = params["encoder"]
    eps = cfg.layer_norm_eps
    x = mel.to(enc["conv1"]["kernel"].dtype)
    x = F.gelu(layers.conv1d(enc["conv1"], x, 1, padding=1))
    x = F.gelu(layers.conv1d(enc["conv2"], x, 2, padding=1)).transpose(1, 2)
    x = x + enc["pos"][:x.shape[1]][None]
    stack = enc["layers"]
    for i in range(stack["attn_ln"]["scale"].shape[0]):
        layer = layers.layer_at(stack, i)
        x = x + _attn(layer["attn"], layers.layer_norm(layer["attn_ln"], x, eps=eps),
                      cfg.encoder_attention_heads)
        x = x + _ffn(layer, layers.layer_norm(layer["final_ln"], x, eps=eps))
    return layers.layer_norm(enc["ln"], x, eps=eps)


def greedy_decode(params: dict, cfg: WhisperConfig, enc_out: Tensor, prefix: Tensor, *,
                  max_new_tokens: int = 32) -> Tuple[Tensor, Tensor]:
    """Greedy generation. enc_out [B, S, d] from `encode`; prefix [B, P]
    forced decoder ids (the start token, plus language / task ids for real
    checkpoints). Returns (tokens [B, max_new_tokens] in prefix's dtype,
    confidences [B, max_new_tokens] f32): the confidence is the step's max
    softmax probability. A row freezes at EOS (it repeats EOS with
    confidence 1). The prefix is fed through the same cached step, and, as
    the JAX package's decode does, a row whose prefix step predicts EOS
    starts frozen."""
    dec = params["decoder"]
    eps = cfg.layer_norm_eps
    B, P = prefix.shape
    Se = enc_out.shape[1]
    H = cfg.decoder_attention_heads
    D = cfg.d_model // H
    S_max = P + max_new_tokens
    stack = dec["layers"]
    per_layer = [layers.layer_at(stack, i) for i in range(stack["self_ln"]["scale"].shape[0])]

    # the cross-attention keys and values are fixed for the whole decode
    cross_kv = [(layers.linear(lay["cross_attn"]["k"], enc_out).reshape(B, Se, H, D),
                 layers.linear(lay["cross_attn"]["v"], enc_out).reshape(B, Se, H, D))
                for lay in per_layer]
    k_cache = enc_out.new_zeros((len(per_layer), B, S_max, H, D))
    v_cache = torch.zeros_like(k_cache)
    positions = torch.arange(S_max, device=enc_out.device)
    eos = torch.tensor(cfg.eos_token_id, dtype=torch.long, device=enc_out.device)

    def one_step(tok: Tensor, step: int, finished: Tensor):
        x = (dec["embed_tokens"][tok] + dec["pos"][step])[:, None, :]
        invalid = (positions > step)[None, None, None, :]
        for i, lay in enumerate(per_layer):
            # causal self-attention over the cache
            q_in = layers.layer_norm(lay["self_ln"], x, eps=eps)
            q = layers.linear(lay["self_attn"]["q"], q_in).reshape(B, 1, H, D)
            k_cache[i, :, step] = layers.linear(lay["self_attn"]["k"], q_in).reshape(B, H, D)
            v_cache[i, :, step] = layers.linear(lay["self_attn"]["v"], q_in).reshape(B, H, D)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k_cache[i]).float() / math.sqrt(D)
            s = s.masked_fill(invalid, -1e30)
            x = x + layers.linear(lay["self_attn"]["out"], _softmax_ctx(s, v_cache[i], x.dtype))
            # cross-attention on the precomputed keys and values
            c_in = layers.layer_norm(lay["cross_ln"], x, eps=eps)
            qc = layers.linear(lay["cross_attn"]["q"], c_in).reshape(B, 1, H, D)
            xk, xv = cross_kv[i]
            sc = torch.einsum("bqhd,bkhd->bhqk", qc, xk).float() / math.sqrt(D)
            x = x + layers.linear(lay["cross_attn"]["out"], _softmax_ctx(sc, xv, x.dtype))
            x = x + _ffn(lay, layers.layer_norm(lay["final_ln"], x, eps=eps))
        x = layers.layer_norm(dec["ln"], x, eps=eps)
        logits = (x[:, 0] @ dec["embed_tokens"].T).float()
        conf = torch.softmax(logits, dim=-1).amax(dim=-1)
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, eos, nxt)
        conf = torch.where(finished, 1.0, conf)
        return nxt, conf, finished | (nxt == eos)

    finished = torch.zeros((B,), dtype=torch.bool, device=enc_out.device)
    prefix_long = prefix.long()
    for i in range(1, P):  # teacher-force the prefix; its outputs are dropped
        _, _, finished = one_step(prefix_long[:, i - 1], i - 1, finished)
    tok = prefix_long[:, P - 1]
    toks, confs = [], []
    for step in range(P - 1, S_max - 1):
        tok, conf, finished = one_step(tok, step, finished)
        toks.append(tok)
        confs.append(conf)
    return torch.stack(toks, 1).to(prefix.dtype), torch.stack(confs, 1)


def transcribe_batch(params: dict, cfg: WhisperConfig, wave: Tensor, prefix: Tensor, *,
                     max_new_tokens: int = 32, pad_to_seconds: Optional[float] = 30.0,
                     sample_rate: int = 16000) -> Tuple[Tensor, Tensor]:
    """[B, T] audio -> (token ids, confidences). Pads or trims to Whisper's
    30 s window (the HF processor's contract) unless pad_to_seconds=None
    keeps the input length (which must still give an even frame count)."""
    if pad_to_seconds is not None:
        T_target = int(pad_to_seconds * sample_rate)
        T = wave.shape[1]
        wave = F.pad(wave, (0, T_target - T)) if T < T_target else wave[:, :T_target]
    mel = log_mel_spectrogram(wave, n_mels=cfg.num_mel_bins)
    enc_out = encode(params, cfg, mel)
    return greedy_decode(params, cfg, enc_out, prefix, max_new_tokens=max_new_tokens)
