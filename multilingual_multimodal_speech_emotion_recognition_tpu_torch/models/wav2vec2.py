"""wav2vec2-base audio encoder, eval only.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/wav2vec2.py for the base preset: masked waveform normalisation, the
7-layer strided conv extractor with a masked group norm on conv 0, feature
projection, grouped positional conv, encoder LN and the post-LN layers with
an additive -inf frame mask. Padded batches give each clip the result it
would get alone, because every statistic is taken over valid samples only.

Layout: the conv stack runs channels-first ([B, C, T], torch's NCW) so that
it needs no transposes, and conv kernels are stored [C_out, C_in/groups, K]
(the weight bridge transposes the JAX package's WIO). feature_encoder and
wav2vec2_encode return [B, T, C] like their JAX counterparts.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2Config
from ..ops import conv_tail
from . import layers

Tensor = torch.Tensor


def check_supported(cfg: Wav2Vec2Config) -> None:
    if (cfg.do_stable_layer_norm or cfg.feat_extract_norm != "group"
            or cfg.gated_relpos_bias):
        raise NotImplementedError(
            "only the wav2vec2-base preset is ported (post-LN, group-norm "
            "conv, no relative position bias); the large presets are "
            "ROADMAP Queue A item 12")


def init_wav2vec2(init: layers.Init, cfg: Wav2Vec2Config) -> dict:
    check_supported(cfg)
    convs = []
    in_c = 1
    for k, out_c in zip(cfg.conv_kernel, cfg.conv_dim):
        conv = {"kernel": init.normal((out_c, in_c, k), math.sqrt(2.0 / (in_c * k)))}
        if cfg.conv_bias:
            conv["bias"] = init.zeros((out_c,))
        convs.append(conv)
        in_c = out_c
    h, g, kk = cfg.hidden_size, cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    L = (cfg.num_hidden_layers,)
    lin = lambda i, o: layers.init_normal_linear(init, i, o, 0.02, stack=L)
    return {
        "convs": convs,
        "feat_proj": {"ln": layers.init_layer_norm(init, cfg.conv_dim[-1]),
                      "proj": layers.init_linear(init, cfg.conv_dim[-1], h)},
        "pos_conv": {"kernel": init.normal((h, h // g, kk), math.sqrt(4.0 / (kk * h))),
                     "bias": init.zeros((h,))},
        "encoder_ln": layers.init_layer_norm(init, h),
        "layers": {
            "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
            "attn_ln": layers.init_layer_norm(init, h, stack=L),
            "ffn_in": lin(h, cfg.intermediate_size),
            "ffn_out": lin(cfg.intermediate_size, h),
            "final_ln": layers.init_layer_norm(init, h, stack=L),
        },
        "masked_spec_embed": init.uniform((h,), 1.0).abs(),  # U[0, 1)
        "group_norm": {"scale": init.ones((cfg.conv_dim[0],)),
                       "bias": init.zeros((cfg.conv_dim[0],))},
    }


def normalize_waveform(wave: Tensor, mask: Tensor, eps: float = 1e-7) -> Tensor:
    """Per-clip zero mean / unit variance over valid samples, zeros on
    padding, computed in f32 (HF zero_mean_unit_var_norm)."""
    wave = wave.float()
    mask = mask.float()
    n = mask.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (wave * mask).sum(-1, keepdim=True) / n
    var = ((wave - mean).square() * mask).sum(-1, keepdim=True) / n
    return (wave - mean) * torch.rsqrt(var + eps) * mask


def _conv1d(p: dict, x: Tensor, stride: int, *, groups: int = 1,
            padding: int = 0) -> Tensor:
    """x: [B, C_in, T]; kernel [C_out, C_in/groups, K] -> [B, C_out, T'].
    The bias is added after the product, in x.dtype."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        # torch's CPU (oneDNN) bf16 grouped conv1d returns wrong values at
        # some shapes (e.g. 4 groups of 4 channels, K=16); an f32 product
        # rounded once to bf16 is what the bf16 conv computes
        y = F.conv1d(x.float(), p["kernel"].to(x.dtype).float(), stride=stride,
                     padding=padding, groups=groups).to(x.dtype)
    else:
        y = F.conv1d(x, p["kernel"].to(x.dtype), stride=stride,
                     padding=padding, groups=groups)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)[:, None]
    return y


def masked_group_norm_per_channel(p: dict, x: Tensor, frame_mask: Tensor,
                                  eps: float = 1e-5) -> Tensor:
    """GroupNorm(C, C) with statistics over valid frames only.
    x: [B, C, T] (channels-first), frame_mask: [B, T]."""
    xf = x.float()
    m = frame_mask.float()[:, None, :]
    n = m.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (xf * m).sum(-1, keepdim=True) / n
    var = ((xf - mean).square() * m).sum(-1, keepdim=True) / n
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()[:, None] + p["bias"].float()[:, None]
    return y.to(x.dtype)


def feature_encoder(params: dict, cfg: Wav2Vec2Config, wave: Tensor,
                    sample_mask: Tensor, *,
                    allow_fused: bool = False) -> Tuple[Tensor, Tensor]:
    """Strided conv stack: [B, T] -> ([B, T7, C], frame_mask [B, T7]).

    `allow_fused=True` runs conv layers 1-6 through the fused tail
    (ops/conv_tail.conv_tail) when the input is bf16 and the stack has the
    tail's geometry (`conv_tail_supported`); otherwise, and by default, the
    layers run one by one. Conv 0 and its masked group norm run either
    way; its output is transposed once to the tail's [B, T1, C]."""
    convs = params["convs"]
    use_fused = (allow_fused and wave.dtype == torch.bfloat16
                 and conv_tail.conv_tail_supported(cfg.conv_kernel, cfg.conv_stride,
                                                   cfg.conv_dim))
    x = _conv1d(convs[0], wave[:, None, :], cfg.conv_stride[0])
    lengths = sample_mask.to(torch.int32).sum(-1)
    lengths = (lengths - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    fm = torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None]
    x = layers.gelu(masked_group_norm_per_channel(params["group_norm"], x, fm))
    if use_fused:
        # the port's extractor is the group-norm one: no per-layer LN
        x = conv_tail.conv_tail(convs, x.transpose(1, 2).contiguous(), has_ln=False,
                                ln_eps=cfg.layer_norm_eps)
    else:
        for conv, stride in zip(convs[1:], cfg.conv_stride[1:]):
            x = layers.gelu(_conv1d(conv, x, stride))
        x = x.transpose(1, 2)
    for kernel, stride in zip(cfg.conv_kernel[1:], cfg.conv_stride[1:]):
        lengths = (lengths - kernel) // stride + 1
    frame_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                  < lengths[:, None]).to(x.dtype)
    return x, frame_mask


def _encoder_stack(stacked: dict, cfg: Wav2Vec2Config, h: Tensor,
                   attn_bias: Tensor) -> Tensor:
    """The post-LN layers; attn_bias: additive f32 [B, 1, 1, S]."""
    return layers.post_ln_encoder_stack(stacked, h, attn_bias,
                                        num_heads=cfg.num_attention_heads,
                                        eps=cfg.layer_norm_eps)


def wav2vec2_encode(params: dict, cfg: Wav2Vec2Config, wave: Tensor,
                    sample_mask: Tensor, *,
                    normalize: bool = True) -> Tuple[Tensor, Tensor]:
    """wave: [B, T] raw 16 kHz audio in the compute dtype; sample_mask:
    [B, T] (1 valid). Returns (hidden [B, T', H], frame_mask [B, T'])."""
    check_supported(cfg)
    if normalize:
        wave = normalize_waveform(wave, sample_mask).to(wave.dtype)
    # the unfused extractor, as the JAX package's wav2vec2_encode runs it
    feats, frame_mask = feature_encoder(params, cfg, wave, sample_mask)
    h = layers.layer_norm(params["feat_proj"]["ln"], feats, eps=cfg.layer_norm_eps)
    h = layers.linear(params["feat_proj"]["proj"], h)
    h = h * frame_mask[..., None].to(h.dtype)
    pos = _conv1d(params["pos_conv"], h.transpose(1, 2), 1,
                  groups=cfg.num_conv_pos_embedding_groups,
                  padding=cfg.num_conv_pos_embeddings // 2)
    # an even kernel with padding k//2 gives T+1 frames: keep the first T
    pos = layers.gelu(pos[:, :, : h.shape[1]].transpose(1, 2))
    h = layers.layer_norm(params["encoder_ln"], h + pos, eps=cfg.layer_norm_eps)
    h = _encoder_stack(params["layers"], cfg, h, layers.key_mask_bias(frame_mask))
    return h, frame_mask
