"""Plain reference of the model the benchmark runs: wav2vec2-family
audio encoder (wav2vec2-base, WavLM-Large), XLM-R text encoder, adapters,
the front-end feature fusion, bidirectional cross-modal attention,
attentive-stats pooling, gated fusion and the 35-layer residual OpenMax
classifier, in the eval forward (no dropout).

Written from the reference repository's `src/models` and the published
Hugging Face models (facebook/wav2vec2-base, microsoft/wavlm-large,
xlm-roberta-base), in the layout of the port's parameter tree (kernels
[in, out], conv kernels [out, in / groups, k], per-layer leaves stacked
[L, ...]), which is the interface through which the benchmark hands both
sides the same weights. It imports nothing of the port.

Precision: the configuration's `compute_dtype` is the dtype of the served
weights and of every activation from the encoders' input waveform to the
fused vector, with each operation in the order the model defines it:
products and convolutions in that dtype (the device accumulates in
float32), biases and residuals added in it, the norms' moments, the
softmaxes and WavLM's gate in float32 and the result cast back. With
bfloat16 that means: the weights are the bfloat16 values of the float32
leaves, for every leaf but the classifier's; the conditioned audio is
rounded to bfloat16 before the waveform normalisation, whose float32
result is rounded again; GELU is the tanh approximation. The front-end
DSP and the classifier (the 35-layer residual stack and OpenMax) run in
float32 whatever the configuration, on the float32 leaves. Float32
products and convolutions are exact float32: callers turn TF32 off (see
`plain_fp32`). On the CPU, where torch has no bfloat16 convolution, a
bfloat16 convolution is the float32 one of the bfloat16 operands,
rounded.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp

Tensor = torch.Tensor


@contextlib.contextmanager
def plain_fp32():
    """Float32 products and convolutions without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compute_dtype(cfg: dict) -> torch.dtype:
    return torch.bfloat16 if cfg["model"]["compute_dtype"] == "bfloat16" else torch.float32


def cast(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def served_weights(weights: dict, compute_dtype: str) -> dict:
    """The weights as the configuration serves them: in its compute dtype,
    but the classifier's in float32."""
    if compute_dtype != "bfloat16":
        return weights
    return {k: (v if k == "classifier" else cast(v, torch.bfloat16)) for k, v in weights.items()}


# ------------------------------------------------------------- primitives

def linear(p: dict, x: Tensor) -> Tensor:
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def layer_norm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Moments and affine in float32, the result in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layer_at(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: layer_at(v, i) for k, v in stacked.items()}
    return stacked[i]


def key_bias(mask: Tensor) -> Tensor:
    """[B, S] validity -> additive [B, 1, 1, S]: -inf on padded keys."""
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    return bias.masked_fill(mask == 0, -math.inf)[:, None, None, :]


def encoder_stack(stacked: dict, h: Tensor, bias: Tensor, *, heads: int, eps: float,
                  pre_ln: bool, gelu: str, logit_bias=None) -> Tensor:
    """Transformer layers, post-LN (LN(x + attn(x)), LN(x + ffn(x))) or
    stable pre-LN (x + attn(LN(x)), x + ffn(LN(x)))."""
    B, S, E = h.shape
    D = E // heads

    def attention(x: Tensor, layer: dict) -> Tensor:
        q = (linear(layer["q"], x) * D ** -0.5).reshape(B, S, heads, D)
        k = linear(layer["k"], x).reshape(B, S, heads, D)
        v = linear(layer["v"], x).reshape(B, S, heads, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias
        if logit_bias is not None:
            logits = logits + logit_bias(layer, x)
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1).to(x.dtype), v)
        return linear(layer["out"], ctx.reshape(B, S, E))

    def ffn(x: Tensor, layer: dict) -> Tensor:
        return linear(layer["ffn_out"], F.gelu(linear(layer["ffn_in"], x), approximate=gelu))

    for i in range(stacked["attn_ln"]["scale"].shape[0]):
        layer = layer_at(stacked, i)
        if pre_ln:
            h = h + attention(layer_norm(layer["attn_ln"], h, eps), layer)
            h = h + ffn(layer_norm(layer["final_ln"], h, eps), layer)
        else:
            h = layer_norm(layer["attn_ln"], h + attention(h, layer), eps)
            h = layer_norm(layer["final_ln"], h + ffn(h, layer), eps)
    return h


# ----------------------------------------------------------- audio encoder

def _conv(p: dict, x: Tensor, stride: int, groups: int = 1, padding: int = 0) -> Tensor:
    """Convolution in x's dtype, then the bias added in it."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        y = F.conv1d(x.float(), p["kernel"].float(), stride=stride, padding=padding,
                     groups=groups).to(x.dtype)
    else:
        y = F.conv1d(x, p["kernel"], stride=stride, padding=padding, groups=groups)
    return y + p["bias"][:, None] if "bias" in p else y


def _channel_norm(p: dict, x: Tensor, mask: Optional[Tensor], eps: float) -> Tensor:
    """Over the channels of each frame (mask None: the layer-norm stack) or
    over each channel's valid frames (the group norm after conv 0); in
    float32, the result in x's dtype."""
    xf = x.float()
    if mask is None:
        mean = xf.mean(1, keepdim=True)
        var = (xf - mean).square().mean(1, keepdim=True)
    else:
        m = mask[:, None, :]
        n = m.sum(-1, keepdim=True).clamp(min=1.0)
        mean = (xf * m).sum(-1, keepdim=True) / n
        var = ((xf - mean).square() * m).sum(-1, keepdim=True) / n
    y = ((xf - mean) * torch.rsqrt(var + eps) * p["scale"].float()[:, None]
         + p["bias"].float()[:, None])
    return y.to(x.dtype)


def relative_bucket(T: int, num_buckets: int, max_distance: int) -> Tensor:
    """WavLM's T5-style bidirectional bucket of key j for query i, [T, T],
    on the CPU (f32 log, truncated)."""
    pos = torch.arange(T)
    rel = pos[None, :] - pos[:, None]
    nb = num_buckets // 2
    out = (rel > 0).to(torch.int64) * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(rel.clamp(min=1).float() / max_exact)
                         / math.log(max_distance / max_exact) * (nb - max_exact)
                         ).to(torch.int64)
    return out + torch.where(rel < max_exact, rel, large.clamp(max=nb - 1))


def audio_encoder(p: dict, a: dict, wave: Tensor, mask: Tensor, gelu: str):
    """wave [B, T] in the compute dtype -> (hidden [B, T', H], frame mask
    [B, T'] in the compute dtype)."""
    eps = a["layer_norm_eps"]
    dt = wave.dtype
    w32 = wave.float()
    n = mask.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (w32 * mask).sum(-1, keepdim=True) / n
    var = ((w32 - mean).square() * mask).sum(-1, keepdim=True) / n
    x = ((w32 - mean) * torch.rsqrt(var + 1e-7) * mask).to(dt)[:, None, :]

    layer_mode = a["feat_extract_norm"] == "layer"
    lengths = mask.sum(-1).to(torch.int64)
    for i, (conv, k, s) in enumerate(zip(p["convs"], a["conv_kernel"], a["conv_stride"])):
        x = _conv(conv, x, s)
        lengths = (lengths - k) // s + 1
        if layer_mode:
            x = _channel_norm(conv["ln"], x, None, eps)
        elif i == 0:
            fm = (torch.arange(x.shape[-1], device=x.device)[None, :] < lengths[:, None]).float()
            x = _channel_norm(p["group_norm"], x, fm, 1e-5)
        x = F.gelu(x, approximate=gelu)
    feats = x.transpose(1, 2)
    frame_mask = (torch.arange(feats.shape[1], device=x.device)[None, :]
                  < lengths[:, None]).to(dt)

    h = linear(p["feat_proj"]["proj"], layer_norm(p["feat_proj"]["ln"], feats, eps))
    h = h * frame_mask[..., None]
    K, G = a["num_conv_pos_embeddings"], a["num_conv_pos_embedding_groups"]
    pos = _conv(p["pos_conv"], h.transpose(1, 2), 1, groups=G, padding=K // 2)
    h = h + F.gelu(pos[:, :, :h.shape[1]].transpose(1, 2), approximate=gelu)
    if not a["do_stable_layer_norm"]:
        h = layer_norm(p["encoder_ln"], h, eps)

    H = a["num_attention_heads"]
    logit_bias = None
    if a["gated_relpos_bias"]:
        bucket = relative_bucket(h.shape[1], a["num_buckets"], a["max_bucket_distance"])
        pos_bias = p["rel_attn_embed"].float()[bucket.to(h.device)].permute(2, 0, 1)  # [H, S, S]

        def logit_bias(layer: dict, x: Tensor) -> Tensor:
            B, S, E = x.shape
            proj = linear(layer["gru_lin"], x.reshape(B, S, H, E // H))
            gates = torch.sigmoid(proj.reshape(B, S, H, 2, 4).sum(-1).float())
            ga, gb = gates[..., :1], gates[..., 1:]
            gate = ga * (gb * layer["gru_const"].float()[None, None, :, None] - 1.0) + 2.0
            return gate.permute(0, 2, 1, 3) * pos_bias[None]

    h = encoder_stack(p["layers"], h, key_bias(frame_mask), heads=H, eps=eps,
                      pre_ln=a["do_stable_layer_norm"], gelu=gelu, logit_bias=logit_bias)
    if a["do_stable_layer_norm"]:
        h = layer_norm(p["encoder_ln"], h, eps)
    return h, frame_mask


# ------------------------------------------------------------ text encoder

def text_encoder(p: dict, t: dict, ids: Tensor, mask: Tensor, gelu: str) -> Tensor:
    emb = p["embeddings"]
    ids = ids.to(torch.int64)
    real = (ids != t["pad_token_id"]).to(torch.int64)
    pos_ids = torch.cumsum(real, -1) * real + t["pad_token_id"]
    h = emb["word"][ids] + emb["position"][pos_ids] + emb["token_type"][0][None, None, :]
    h = layer_norm(emb["ln"], h, t["layer_norm_eps"])
    return encoder_stack(p["layers"], h, key_bias(mask), heads=t["num_attention_heads"],
                         eps=t["layer_norm_eps"], pre_ln=False, gelu=gelu)


# ------------------------------------------------------------------- heads

def _adapter(p: dict, x: Tensor) -> Tensor:
    return x + linear(p["up"], torch.relu(linear(p["down"], x)))


def _feature_proj(p: dict, feats: Tensor) -> Tensor:
    return linear(p["lin2"], torch.relu(linear(p["lin1"], feats)))


def _feature_fuse(p: dict, seq: Tensor, feats: Tensor) -> Tensor:
    B, S, _ = seq.shape
    f = feats[:, None, :].expand(B, S, feats.shape[-1]).to(seq.dtype)
    return torch.relu(linear(p["lin"], torch.cat([seq, f], -1)))


def _mha(p: dict, q: Tensor, k: Tensor, v: Tensor, heads: int, key_mask: Tensor) -> Tensor:
    B, Sq, E = q.shape
    Sk = k.shape[1]
    D = E // heads
    qh = linear(p["q"], q).reshape(B, Sq, heads, D)
    kh = linear(p["k"], k).reshape(B, Sk, heads, D)
    vh = linear(p["v"], v).reshape(B, Sk, heads, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() / math.sqrt(D)
    logits = logits.masked_fill((key_mask == 0)[:, None, None, :], -math.inf)
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1).to(q.dtype), vh)
    return linear(p["out"], ctx.reshape(B, Sq, E))


def _pool(p: dict, x: Tensor, mask: Tensor) -> Tensor:
    scores = linear(p["w2"], torch.tanh(linear(p["w1"], x)))[..., 0].float()
    attn = torch.softmax(scores.masked_fill(mask == 0, -math.inf), -1).to(x.dtype)[..., None]
    mean = (attn * x).sum(1)
    var = (attn * (x - mean[:, None, :]).square()).sum(1)
    return torch.cat([mean, torch.sqrt(var + 1e-6)], -1)


def _fusion(p: dict, a_vec: Tensor, t_vec: Tensor) -> Tensor:
    a = linear(p["proj_a2"], torch.relu(linear(p["proj_a1"], a_vec)))
    t = linear(p["proj_t2"], torch.relu(linear(p["proj_t1"], t_vec)))
    wa = torch.sigmoid(linear(p["gate_a2"], torch.relu(linear(p["gate_a1"], a))))
    wt = torch.sigmoid(linear(p["gate_t2"], torch.relu(linear(p["gate_t1"], t))))
    wsum = wa + wt + 1e-8
    return (wa / wsum) * a + (wt / wsum) * t


def classifier(p: dict, x: Tensor, use_openmax: bool):
    """(logits [B, C], uncertainty [B, 1]) of the residual OpenMax head."""
    h = torch.relu(layer_norm(p["input_ln"], linear(p["input_proj"], x)))
    stacked = p["layers"]
    for i in range(stacked["block_lin1"]["kernel"].shape[0]):
        layer = layer_at(stacked, i)
        y = layer_norm(layer["ln_pre"], h)
        b = torch.relu(linear(layer["block_lin1"], layer_norm(layer["block_ln"], y)))
        h = y + linear(layer["block_lin2"], b)
    feats = torch.relu(layer_norm(p["out_ln"], linear(p["out_proj1"], h)))
    logits = linear(p["out_proj2"], feats)
    u = torch.sigmoid(linear(p["uncertainty"]["lin2"],
                             torch.relu(linear(p["uncertainty"]["lin1"], feats))))
    if use_openmax:
        w = p["weibull"]
        dist = torch.linalg.vector_norm(feats[:, None, :] - w["activation_vectors"][None], dim=-1)
        x_ = (dist - w["tau"][None, :]).clamp(min=0.0) / w["beta"].clamp(min=1e-6)[None, :]
        unknown = (1.0 - torch.exp(-torch.pow(x_, w["alpha"][None, :]))).max(-1).values
        scale = torch.where(unknown > 0.3, 1.0 - 0.8 * unknown, torch.ones_like(unknown))
        logits = logits * scale[:, None]
    return logits, u


# ----------------------------------------------------------------- forward

def _gelu_mode(cfg: dict) -> str:
    return "tanh" if cfg["model"]["compute_dtype"] == "bfloat16" else "none"


def encode(w: dict, cfg: dict, wave: Tensor, mask: Tensor, text_ids: Tensor,
           text_mask: Tensor, *, text_tile: int = 1):
    """The front end, both encoders and the feature fusion, on served
    weights `w`: (audio seq, frame mask, text seq, text mask). The text
    side runs once and is tiled `text_tile` times, view-major."""
    m, a, t = cfg["model"], cfg["audio"], cfg["text"]
    gelu = _gelu_mode(cfg)
    q = c = None
    if m["frontend_dsp"] and (m["use_quality_gates"] or m["use_audio_conditioning"]):
        wave, q, c = dsp.frontend(wave, mask, sample_rate=16000,
                                  use_gates=m["use_quality_gates"],
                                  use_conditioning=m["use_audio_conditioning"],
                                  zero_non_accept=m["zero_non_accept"])
    dt = compute_dtype(cfg)
    seq, frame_mask = audio_encoder(w["audio_backbone"], a, wave.to(dt), mask, gelu)
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


def heads(w: dict, cfg: dict, a_seq, a_mask, t_seq, t_mask, use_openmax: bool):
    m = cfg["model"]
    cr = w["cross"]
    H = m["num_heads"]
    a_ctx = _mha(cr["attn_a"], linear(cr["q_a"], a_seq), linear(cr["k_t"], t_seq),
                 linear(cr["v_t"], t_seq), H, t_mask)
    a_enh = layer_norm(cr["norm_a"], a_seq + linear(cr["out_a"], a_ctx))
    t_ctx = _mha(cr["attn_t"], linear(cr["q_t"], t_seq), linear(cr["k_a"], a_seq),
                 linear(cr["v_a"], a_seq), H, a_mask)
    t_enh = layer_norm(cr["norm_t"], t_seq + linear(cr["out_t"], t_ctx))
    fused = _fusion(w["fusion"], _pool(w["pool_a"], a_enh, a_mask),
                    _pool(w["pool_t"], t_enh, t_mask))
    return classifier(w["classifier"], fused.float(), use_openmax)


def forward(weights: dict, cfg: dict, batch: dict, *, use_openmax: bool = True):
    """The eval forward on one batch (audio [B, T], audio_mask, text_ids
    [B, S], text_mask): (logits [B, C], uncertainty [B, 1])."""
    w = served_weights(weights, cfg["model"]["compute_dtype"])
    enc = encode(w, cfg, batch["audio"].float(), batch["audio_mask"].float(),
                 batch["text_ids"], batch["text_mask"].float())
    return heads(w, cfg, *enc, use_openmax=use_openmax)


# --------------------------------------------------------------------- TTA

def _resample_kernel(orig: int, new: int, width_lp: int = 6, rolloff: float = 0.99):
    """torchaudio's windowed-sinc kernel (hann, lowpass width 6, rolloff
    0.99), [new, 2 * width + orig], in float64 then float32."""
    base = min(orig, new) * rolloff
    width = math.ceil(width_lp * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new) + idx
    t = np.clip(t * base, -width_lp, width_lp)
    window = np.cos(t * np.pi / width_lp / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * (base / orig)
    return kernel.astype(np.float32), width


def resample(wave: Tensor, orig_freq: int, new_freq: int) -> Tensor:
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    kernel, width = _resample_kernel(orig, new)
    k = torch.from_numpy(np.ascontiguousarray(kernel.T)).to(wave.device)
    B, T = wave.shape
    x = F.pad(wave, (width, width + orig))
    y = torch.matmul(x.unfold(-1, k.shape[0], orig), k)
    return y.reshape(B, -1)[:, :int(math.ceil(new * T / orig))]


def speed_perturb(wave: Tensor, factor: float, sr: int) -> Tensor:
    T = wave.shape[-1]
    out = resample(resample(wave, sr, int(sr * factor)), int(sr * factor), sr)
    return out[..., :T] if out.shape[-1] >= T else F.pad(out, (0, T - out.shape[-1]))


def speed_length(length: Tensor, factor: float, sr: int) -> Tensor:
    """Valid samples after the double resample, as integer products and an
    f32 division and ceil, twice."""
    new_sr = int(sr * factor)
    g = math.gcd(sr, new_sr)
    mid = torch.ceil((length.to(torch.int32) * (new_sr // g)).float() / (sr // g))
    return torch.ceil(mid * (sr // g) / (new_sr // g)).to(torch.int32)


def add_noise(wave: Tensor, mask: Tensor, snr_db: float, noise: Tensor) -> Tensor:
    n = mask.sum(-1, keepdim=True).clamp(min=1.0)
    power = ((wave * wave * mask).sum(-1, keepdim=True) / n).clamp(min=1e-12)
    noise_power = power / float(np.float32(10.0) ** (np.float32(snr_db) / 10))
    return (wave + noise * torch.sqrt(noise_power)).clamp(-1.0, 1.0) * mask


def tta_views(wave: Tensor, mask: Tensor, noise, num_tta: int, sr: int = 16000):
    """[orig, speed 0.95, speed 1.05, noise 15 dB, noise 20 dB][:num_tta],
    view-major [V * B, T], with their masks."""
    T = wave.shape[1]
    views = [(wave, mask)]
    lengths = mask.to(torch.int32).sum(-1, dtype=torch.int32)
    positions = torch.arange(T, device=wave.device)[None, :]
    for f in (0.95, 1.05)[:max(num_tta - 1, 0)]:
        m = (positions < speed_length(lengths, f, sr).clamp(max=T)[:, None]).to(mask.dtype)
        views.append((speed_perturb(wave, f, sr) * m, m))
    for i, snr in enumerate((15.0, 20.0)[:max(num_tta - 3, 0)]):
        views.append((add_noise(wave, mask, snr, noise[i].float()), mask))
    return torch.cat([v[0] for v in views], 0), torch.cat([v[1] for v in views], 0)


def tta_forward(weights: dict, cfg: dict, batch: dict, noise, *, num_tta: int = 5,
                use_openmax: bool = True) -> Tensor:
    """The 5-view TTA eval: one forward over the expanded batch, the text
    side once, logits [B, C] meaned over the views."""
    w = served_weights(weights, cfg["model"]["compute_dtype"])
    B = batch["audio"].shape[0]
    wave, mask = tta_views(batch["audio"].float(), batch["audio_mask"].float(), noise, num_tta)
    enc = encode(w, cfg, wave, mask, batch["text_ids"], batch["text_mask"].float(),
                 text_tile=num_tta)
    logits, _ = heads(w, cfg, *enc, use_openmax=use_openmax)
    return logits.reshape(num_tta, B, -1).mean(0)
