"""The wav2vec2-family audio encoder: wav2vec2-base, wav2vec2-large,
HuBERT-Large and WavLM-Large.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/wav2vec2.py: masked waveform normalisation, the 7-layer strided conv
extractor, feature projection, grouped positional conv and the transformer
layers with an additive -inf frame mask. Two extractors: the base one
(`feat_extract_norm="group"`: a masked group norm after conv 0) and the
large one ("layer": a per-frame channel LayerNorm after every conv, with
conv biases where `conv_bias`). Two layer orders: post-LN (base, encoder
LN before the stack) and stable pre-LN (`do_stable_layer_norm`: the large
presets, encoder LN after the stack). WavLM (`gated_relpos_bias`) adds a
T5-style bucketed relative position bias, computed once and shared down
the stack, gated per layer, head and query from the attention's input.
Padded batches give each clip the result it would get alone, because
every statistic is taken over valid samples only or per frame.
In training (deterministic=False) SpecAugment's time masks and the
dropout sites of the JAX package apply, drawn from a torch.Generator.

Layout: the conv stack runs channels-first ([B, C, T], torch's NCW) so that
it needs no transposes, and conv kernels are stored [C_out, C_in/groups, K]
(the weight bridge transposes the JAX package's WIO). feature_encoder and
wav2vec2_encode return [B, T, C] like their JAX counterparts.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2Config
from ..ops import conv_tail
from ..utils.runtime import export_safe_cache
from . import layers, remat as remat_lib

Tensor = torch.Tensor


FEAT_EXTRACT_NORMS = ("group", "layer")


def check_supported(cfg: Wav2Vec2Config) -> None:
    if cfg.feat_extract_norm not in FEAT_EXTRACT_NORMS:
        raise NotImplementedError(
            f"feat_extract_norm={cfg.feat_extract_norm!r}: the extractor takes "
            f"{' or '.join(map(repr, FEAT_EXTRACT_NORMS))}, as the JAX package's does")


def init_wav2vec2(init: layers.Init, cfg: Wav2Vec2Config) -> dict:
    """The JAX package's tree and init distributions: per-conv `bias` and
    `ln` where the config has them, `group_norm` in group mode only, and
    WavLM's per-layer `gru_lin` [L, Dh, 8] / `gru_const` [L, H] and
    `rel_attn_embed` [num_buckets, H]."""
    check_supported(cfg)
    convs = []
    in_c = 1
    for k, out_c in zip(cfg.conv_kernel, cfg.conv_dim):
        conv = {"kernel": init.normal((out_c, in_c, k), math.sqrt(2.0 / (in_c * k)))}
        if cfg.conv_bias:
            conv["bias"] = init.zeros((out_c,))
        if cfg.feat_extract_norm == "layer":
            conv["ln"] = layers.init_layer_norm(init, out_c)
        convs.append(conv)
        in_c = out_c
    h, g, kk = cfg.hidden_size, cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    H = cfg.num_attention_heads
    L = (cfg.num_hidden_layers,)
    lin = lambda i, o: layers.init_normal_linear(init, i, o, 0.02, stack=L)
    stacked = {
        "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
        "attn_ln": layers.init_layer_norm(init, h, stack=L),
        "ffn_in": lin(h, cfg.intermediate_size),
        "ffn_out": lin(cfg.intermediate_size, h),
        "final_ln": layers.init_layer_norm(init, h, stack=L),
    }
    if cfg.gated_relpos_bias:
        stacked["gru_lin"] = lin(h // H, 8)
        stacked["gru_const"] = init.ones((*L, H))
    params = {
        "convs": convs,
        "feat_proj": {"ln": layers.init_layer_norm(init, cfg.conv_dim[-1]),
                      "proj": layers.init_linear(init, cfg.conv_dim[-1], h)},
        "pos_conv": {"kernel": init.normal((h, h // g, kk), math.sqrt(4.0 / (kk * h))),
                     "bias": init.zeros((h,))},
        "encoder_ln": layers.init_layer_norm(init, h),
        "layers": stacked,
        "masked_spec_embed": init.uniform((h,), 1.0).abs(),  # U[0, 1)
    }
    if cfg.feat_extract_norm == "group":
        params["group_norm"] = {"scale": init.ones((cfg.conv_dim[0],)),
                                "bias": init.zeros((cfg.conv_dim[0],))}
    if cfg.gated_relpos_bias:
        params["rel_attn_embed"] = init.normal((cfg.num_buckets, H), 0.02)
    return params


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


def channel_layer_norm(p: dict, x: Tensor, eps: float) -> Tensor:
    """`layers.layer_norm` over the channels of each frame of a
    channels-first x [B, C, T] (HF Wav2Vec2LayerNormConvLayer): f32
    moments, returns x.dtype."""
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    var = (xf - mean).square().mean(1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()[:, None] + p["bias"].float()[:, None]
    return y.to(x.dtype)


def feature_encoder(params: dict, cfg: Wav2Vec2Config, wave: Tensor,
                    sample_mask: Tensor, *,
                    allow_fused: bool = False) -> Tuple[Tensor, Tensor]:
    """Strided conv stack: [B, T] -> ([B, T7, C], frame_mask [B, T7]).

    Each conv adds its bias where it has one; in layer mode a per-frame
    channel LayerNorm follows every conv, in group mode a masked group norm
    follows conv 0 only; then GELU. `allow_fused=True` runs conv layers 1-6
    through the fused tail (ops/conv_tail.conv_tail, with the per-layer LN
    in layer mode) when the input is bf16 and the stack has the tail's
    geometry (`conv_tail_supported`); otherwise, and by default, the layers
    run one by one. Conv 0 and its norm run either way; its output is
    transposed once to the tail's [B, T1, C]."""
    check_supported(cfg)
    convs = params["convs"]
    layer_mode = cfg.feat_extract_norm == "layer"
    eps = cfg.layer_norm_eps

    def norm_gelu(conv: dict, x: Tensor) -> Tensor:
        return layers.gelu(channel_layer_norm(conv["ln"], x, eps) if layer_mode else x)

    use_fused = (allow_fused and wave.dtype == torch.bfloat16
                 and conv_tail.conv_tail_supported(cfg.conv_kernel, cfg.conv_stride,
                                                   cfg.conv_dim))
    x = _conv1d(convs[0], wave[:, None, :], cfg.conv_stride[0])
    lengths = sample_mask.to(torch.int32).sum(-1)
    lengths = (lengths - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1
    if layer_mode:
        x = norm_gelu(convs[0], x)
    else:
        fm = torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None]
        x = layers.gelu(masked_group_norm_per_channel(params["group_norm"], x, fm))
    if use_fused:
        x = conv_tail.conv_tail(convs, x.transpose(1, 2).contiguous(), has_ln=layer_mode,
                                ln_eps=eps)
    else:
        for conv, stride in zip(convs[1:], cfg.conv_stride[1:]):
            x = norm_gelu(conv, _conv1d(conv, x, stride))
        x = x.transpose(1, 2)
    for kernel, stride in zip(cfg.conv_kernel[1:], cfg.conv_stride[1:]):
        lengths = (lengths - kernel) // stride + 1
    frame_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                  < lengths[:, None]).to(x.dtype)
    return x, frame_mask


def _spec_augment(generator: torch.Generator, cfg: Wav2Vec2Config, hidden: Tensor,
                  frame_mask: Tensor, masked_embed: Tensor) -> Tensor:
    """SpecAugment time masks as the JAX package draws them: Bernoulli
    starts with p = mask_time_prob / mask_time_length * 2, each dilated
    over the mask_time_length frames from it on (a left-padded max-pool),
    kept on valid frames only; masked frames become masked_spec_embed."""
    B, T, _ = hidden.shape
    width = cfg.mask_time_length
    p_start = cfg.mask_time_prob / width * 2.0
    starts = (torch.rand((B, T), generator=generator, device=hidden.device)
              < p_start).float()
    masked = F.max_pool1d(F.pad(starts[:, None, :], (width - 1, 0)), width, stride=1)[:, 0]
    masked = masked * frame_mask.float()
    return torch.where(masked[..., None] > 0, masked_embed.to(hidden.dtype), hidden)


def _relative_positions_bucket(rel: Tensor, num_buckets: int, max_distance: int) -> Tensor:
    """HF WavLMAttention._relative_positions_bucket as the JAX package
    computes it (T5-style, bidirectional): half the buckets for the sign,
    half of those exact, the rest log-spaced; the log in f32, truncated to
    an integer before max_exact is added."""
    nb = num_buckets // 2
    out = (rel > 0).to(torch.int64) * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(rel.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact) * (nb - max_exact)
                         ).to(torch.int64)
    return out + torch.where(rel < max_exact, rel, large.clamp(max=nb - 1))


@export_safe_cache(maxsize=16)
def _bucket_table(T: int, num_buckets: int, max_distance: int) -> Tensor:
    """Bucket [T, T] of key j for query i (rel = j - i), always computed on
    the CPU, so that every device indexes the same buckets (a device's own
    f32 log may round the other way at a bucket edge)."""
    pos = torch.arange(T)
    return _relative_positions_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)


def relative_position_bias(params: dict, cfg: Wav2Vec2Config, T: int) -> Tensor:
    """Ungated bias [H, T, T] in f32 (HF WavLMAttention.compute_bias), from
    `rel_attn_embed`, computed once and shared down the stack."""
    embed = params["rel_attn_embed"]
    bucket = _bucket_table(T, cfg.num_buckets, cfg.max_bucket_distance).to(embed.device)
    return embed.float()[bucket].permute(2, 0, 1)


def _gated_bias(pos_bias: Tensor, num_heads: int, heads: Optional[Tuple[int, int]] = None):
    """logit_bias(layer, x) of `layers.encoder_stack`: WavLM's gate, from
    the attention's input x [B, S, E] (after the LN in stable-LN mode), per
    (batch, head, query): sigmoid of gru_lin's two sums of 4, then
    ga * (gb * gru_const - 1) + 2, [B, H, S, 1], times the bias, in f32.
    `heads` = (lo, hi) restricts it to those heads (a tensor-parallel rank's:
    pos_bias and gru_const are theirs already); all of them by default."""
    lo, hi = heads or (0, num_heads)

    def bias(layer: dict, x: Tensor) -> Tensor:
        B, S, E = x.shape
        Dh = E // num_heads
        x = x.narrow(-1, lo * Dh, (hi - lo) * Dh)
        proj = layers.linear(layer["gru_lin"], x.reshape(B, S, hi - lo, Dh))
        gates = torch.sigmoid(proj.reshape(B, S, hi - lo, 2, 4).sum(-1).float())
        ga, gb = gates[..., :1], gates[..., 1:]
        const = layer["gru_const"].float()[None, None, :, None]
        gate = (ga * (gb * const - 1.0) + 2.0).permute(0, 2, 1, 3)
        return gate * pos_bias[None]
    return bias


def _encoder_stack(stacked: dict, cfg: Wav2Vec2Config, h: Tensor, attn_bias: Tensor, *,
                   generator: Optional[torch.Generator] = None, deterministic: bool = True,
                   remat: remat_lib.RematSpec = False,
                   pos_bias: Optional[Tensor] = None, tp=None) -> Tensor:
    """The transformer layers (post-LN, or pre-LN with do_stable_layer_norm);
    attn_bias: additive f32 [B, 1, 1, S]; pos_bias: WavLM's [H, S, S] (this
    rank's heads' under `tp`, a parallel/tensor.ModelGroup, whose gate
    reads its heads' chunk of the input with the replicated gru_lin and its
    heads' gru_const)."""
    H = cfg.num_attention_heads
    heads = None
    if tp is not None and pos_bias is not None:
        from ..parallel import tensor as tpl
        heads = tp.span(H, "WavLM gate heads")
        stacked = {**stacked,
                   "gru_lin": {k: tpl.copy_to_model(v, tp)
                               for k, v in stacked["gru_lin"].items()},
                   "gru_const": tpl.local_part(stacked["gru_const"], -1, heads, tp)}
    return layers.encoder_stack(
        stacked, h, attn_bias, num_heads=H, eps=cfg.layer_norm_eps,
        pre_ln=cfg.do_stable_layer_norm,
        logit_bias=None if pos_bias is None else _gated_bias(pos_bias, H, heads),
        attention_dropout=cfg.attention_dropout, hidden_dropout=cfg.hidden_dropout,
        activation_dropout=cfg.activation_dropout, generator=generator,
        deterministic=deterministic, remat=remat, tp=tp)


def _positional_conv(params: dict, cfg: Wav2Vec2Config, h: Tensor, tp=None) -> Tensor:
    """GELU of the grouped positional conv of h [B, T, C], [B, T, C]. Under
    `tp` (a parallel/tensor.ModelGroup) this rank convolves its groups alone
    (its output channels are its shard of the kernel, and a group reads its
    own channels of h), then the channels are gathered over the group."""
    G, K = cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    x, conv, groups = h.transpose(1, 2), params["pos_conv"], G
    if tp is not None:
        from ..parallel import tensor as tpl
        g_lo, g_hi = tp.span(G, "pos_conv groups")
        per = h.shape[-1] // G
        span = (g_lo * per, g_hi * per)
        x = tpl.local_part(x, 1, span, tp)
        conv = {**conv, "bias": tpl.local_part(conv["bias"], 0, span, tp)}
        groups = g_hi - g_lo
    pos = _conv1d(conv, x, 1, groups=groups, padding=K // 2)
    # an even kernel with padding k//2 gives T+1 frames: keep the first T
    pos = layers.gelu(pos[:, :, : h.shape[1]].transpose(1, 2))
    return pos if tp is None else tpl.gather_from_model(pos, 2, tp)


def wav2vec2_encode(params: dict, cfg: Wav2Vec2Config, wave: Tensor,
                    sample_mask: Tensor, *, normalize: bool = True,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    spec_augment: bool = False,
                    remat: remat_lib.RematSpec = False, tp=None) -> Tuple[Tensor, Tensor]:
    """wave: [B, T] raw 16 kHz audio in the compute dtype; sample_mask:
    [B, T] (1 valid). Returns (hidden [B, T', H], frame_mask [B, T']).
    Training draws SpecAugment (where `spec_augment` and the config ask
    for it) and dropout from `generator`. Under `tp` (a
    parallel/tensor.ModelGroup) the positional conv and the layers run
    tensor-parallel on this rank's shards; the rest is replicated."""
    if normalize:
        wave = normalize_waveform(wave, sample_mask).to(wave.dtype)
    # the unfused extractor, as the JAX package's wav2vec2_encode runs it
    feats, frame_mask = feature_encoder(params, cfg, wave, sample_mask)
    h = layers.layer_norm(params["feat_proj"]["ln"], feats, eps=cfg.layer_norm_eps)
    h = layers.linear(params["feat_proj"]["proj"], h)
    if spec_augment and not deterministic and cfg.apply_spec_augment:
        h = _spec_augment(generator, cfg, h, frame_mask, params["masked_spec_embed"])
    h = h * frame_mask[..., None].to(h.dtype)
    h = h + _positional_conv(params, cfg, h, tp)
    if not cfg.do_stable_layer_norm:
        # the post-LN encoder normalises before the stack, the stable-LN one after
        h = layers.layer_norm(params["encoder_ln"], h, eps=cfg.layer_norm_eps)
    h = layers.dropout(generator, h, cfg.hidden_dropout, deterministic)
    pos_bias = None
    if cfg.gated_relpos_bias:
        table = params
        if tp is not None:
            from ..parallel import tensor as tpl
            table = {"rel_attn_embed": tpl.local_part(
                params["rel_attn_embed"], -1,
                tp.span(cfg.num_attention_heads, "WavLM bias heads"), tp)}
        pos_bias = relative_position_bias(table, cfg, h.shape[1])
    h = _encoder_stack(params["layers"], cfg, h, layers.key_mask_bias(frame_mask),
                       generator=generator, deterministic=deterministic, remat=remat,
                       pos_bias=pos_bias, tp=tp)
    if cfg.do_stable_layer_norm:
        h = layers.layer_norm(params["encoder_ln"], h, eps=cfg.layer_norm_eps)
    return h, frame_mask
