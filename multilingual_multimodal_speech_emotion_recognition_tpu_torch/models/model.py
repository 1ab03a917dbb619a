"""The full SER model's forward over one nested dict of parameters.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/model.py: wav2vec2 (+ adapter, + quality/conditioning feature
fusion), XLM-R (+ adapter, + ASR feature fusion), bidirectional cross-modal
attention, attentive-stats pooling x2, gated fusion, then the 35-layer
OpenMax classifier. With compute_dtype "bfloat16" the encoders,
cross-attention, pooling and fusion run on bf16 copies of their
parameters, while the classifier runs in f32 on the raw parameters.

A batch without `quality_feats` / `cond_feats` runs the front-end DSP
(quality gates, then conditioning) on its waveform first, where the config
enables it.

`deterministic=False` is the training forward: dropout at the JAX
package's sites and rates (the feature projections' and fusions' 0.1
included), SpecAugment where asked, all drawn from one torch.Generator on
the parameters' device, and the classifier's plain residual stack. An
encoder whose parameters carry no gradient (frozen backbones: the train
step passes them detached, as JAX stop_gradients them) runs under
torch.no_grad(), so none of its activations are kept; its dropout and
SpecAugment still apply, as in the reference's train() mode.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Union

import torch

from ..config import ModelConfig
from ..frontend import frontend_process
from ..ops import pooling as pooling_ops
from ..utils.runtime import leaves_with_paths, resolve_device, to_device, tree_to
from . import classifier as clf
from . import cross_attention as cma
from . import fusion as fusion_mod
from . import layers
from . import wav2vec2 as w2v
from . import xlmr as xlmr_mod

Tensor = torch.Tensor

_HEAD_KEYS = ("cross", "pool_a", "pool_t", "fusion")
_UNCAST_KEYS = _HEAD_KEYS + ("classifier", "prototypes")


class ModelOutput(NamedTuple):
    logits: Tensor               # [B, C]
    uncertainty: Tensor          # [B, 1]
    anchor_loss: Tensor          # scalar
    anchor_similarities: Tensor  # [B, C]
    features: Tensor             # [B, base_dim//2] classifier penultimate
    fused: Tensor                # [B, proj_dim] fusion output
    audio_vec: Tensor            # [B, 2*audio_hidden]
    text_vec: Tensor             # [B, 2*text_hidden]


def _init_feature_fusion(init: layers.Init, hid: int, extra: int) -> dict:
    return {"lin": layers.init_linear(init, hid + extra, hid)}


def _init_feature_proj(init: layers.Init, dim: int) -> dict:
    return {"lin1": layers.init_linear(init, dim, 32),
            "lin2": layers.init_linear(init, 32, dim)}


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: Optional[Union[str, torch.device]] = None,
               dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters with the JAX package's tree, shapes and init
    distributions (the values differ from JAX's). `generator` must live on
    `device`; None seeds one with 0. The card unless `device` says
    otherwise; "meta" gives shapes only."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    init = layers.Init(generator, dev, dtype)
    ah, th = cfg.audio_hidden, cfg.text_hidden
    params = {
        "audio_backbone": w2v.init_wav2vec2(init, cfg.audio),
        "audio_adapter": {"down": layers.init_linear(init, ah, cfg.adapter_dim),
                          "up": layers.init_linear(init, cfg.adapter_dim, ah)},
        "text_backbone": xlmr_mod.init_xlmr(init, cfg.text),
        "text_adapter": {"down": layers.init_linear(init, th, cfg.adapter_dim),
                         "up": layers.init_linear(init, cfg.adapter_dim, th)},
        "asr_fusion": _init_feature_fusion(init, th, 8),
        "asr_proj": _init_feature_proj(init, 8),
        "cross": cma.init_cross_modal_attention(init, ah, th, cfg.shared_dim),
        "pool_a": pooling_ops.init_attentive_stats_pooling(init, ah),
        "pool_t": pooling_ops.init_attentive_stats_pooling(init, th),
        "fusion": fusion_mod.init_fusion(init, 2 * ah, 2 * th, cfg.proj_dim),
        "classifier": clf.init_classifier(init, cfg.proj_dim, cfg.num_labels,
                                          cfg.classifier_layers,
                                          cfg.classifier_base_dim),
        "prototypes": {"prototypes": init.normal((cfg.num_labels, cfg.proj_dim), 0.02)},
    }
    if cfg.use_quality_gates and cfg.use_audio_conditioning:
        params["combined_fusion"] = _init_feature_fusion(init, ah, 20)
    elif cfg.use_quality_gates:
        params["quality_fusion"] = _init_feature_fusion(init, ah, 8)
    elif cfg.use_audio_conditioning:
        params["conditioning_fusion"] = _init_feature_fusion(init, ah, 12)
    if cfg.use_quality_gates:
        params["quality_proj"] = _init_feature_proj(init, 8)
    if cfg.use_audio_conditioning:
        params["cond_proj"] = _init_feature_proj(init, 12)
    return params


def cast_floating(tree, dtype: torch.dtype):
    """Cast floating leaves to `dtype`; integer leaves and int8
    dequantisation scales (`w_scale`) pass through."""
    if isinstance(tree, dict):
        return {k: (v if k == "w_scale" else cast_floating(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def encoder_params(params: dict, cfg: ModelConfig) -> dict:
    """The compute-dtype copy of what encode_audio / encode_text read (the
    heads cast their own; the classifier stays f32)."""
    dtype = _compute_dtype(cfg)
    return {k: cast_floating(v, dtype) for k, v in params.items()
            if k not in _UNCAST_KEYS}


def _adapter(p: dict, x: Tensor) -> Tensor:
    """Bottleneck adapter with a residual add."""
    return x + layers.linear(p["up"], torch.relu(layers.linear(p["down"], x)))


FEATURE_DROPOUT = 0.1  # the feature projections' and fusions' fixed rate


def _feature_proj(p: dict, feats: Tensor, generator: Optional[torch.Generator],
                  deterministic: bool) -> Tensor:
    """Linear(d, 32) -> ReLU -> Dropout(0.1) -> Linear(32, d)."""
    h = torch.relu(layers.linear(p["lin1"], feats))
    h = layers.dropout(generator, h, FEATURE_DROPOUT, deterministic)
    return layers.linear(p["lin2"], h)


def _feature_fuse(p: dict, seq: Tensor, feats: Tensor,
                  generator: Optional[torch.Generator], deterministic: bool) -> Tensor:
    """Broadcast per-utterance features along time, concat, Linear + ReLU
    + Dropout(0.1)."""
    B, S, _ = seq.shape
    f = feats[:, None, :].expand(B, S, feats.shape[-1]).to(seq.dtype)
    y = torch.relu(layers.linear(p["lin"], torch.cat([seq, f], dim=-1)))
    return layers.dropout(generator, y, FEATURE_DROPOUT, deterministic)


def _frozen(tree) -> contextlib.AbstractContextManager:
    """torch.no_grad() where no leaf of `tree` wants a gradient, so that a
    frozen encoder keeps no activations; else, or where no gradient is
    recorded anyway (an eval forward; torch.export would trace a grad-mode
    switch), nothing."""
    if not torch.is_grad_enabled() or any(t.requires_grad for _, t in leaves_with_paths(tree)):
        return contextlib.nullcontext()
    return torch.no_grad()


def encode_audio(params: dict, cfg: ModelConfig, wave: Tensor, wave_mask: Tensor,
                 *, quality_feats: Optional[Tensor] = None,
                 cond_feats: Optional[Tensor] = None, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 spec_augment: bool = False, tp=None):
    """[B, T] waveform -> ([B, T', ah] sequence, [B, T'] frame mask); the
    backbone tensor-parallel under `tp` (a parallel/tensor.ModelGroup)."""
    with _frozen(params["audio_backbone"]):
        seq, frame_mask = w2v.wav2vec2_encode(
            params["audio_backbone"], cfg.audio, wave, wave_mask,
            deterministic=deterministic, generator=generator,
            spec_augment=spec_augment, remat=cfg.remat_encoders, tp=tp)
    seq = _adapter(params["audio_adapter"], seq)
    drop = (generator, deterministic)
    uq, uc = cfg.use_quality_gates, cfg.use_audio_conditioning
    if uq or uc:
        B = seq.shape[0]
        q = quality_feats if quality_feats is not None else seq.new_zeros((B, 8))
        c = cond_feats if cond_feats is not None else seq.new_zeros((B, 12))
        if uq:
            q = _feature_proj(params["quality_proj"], q.to(seq.dtype), *drop)
        if uc:
            c = _feature_proj(params["cond_proj"], c.to(seq.dtype), *drop)
        if uq and uc:
            seq = _feature_fuse(params["combined_fusion"], seq, torch.cat([q, c], -1), *drop)
        elif uq:
            seq = _feature_fuse(params["quality_fusion"], seq, q, *drop)
        else:
            seq = _feature_fuse(params["conditioning_fusion"], seq, c, *drop)
    if cfg.pad_frames_valid:
        seq = seq * frame_mask[..., None].to(seq.dtype)
        frame_mask = torch.ones_like(frame_mask)
    return seq, frame_mask


def encode_text(params: dict, cfg: ModelConfig, input_ids: Tensor,
                text_mask: Tensor, *, asr_feats: Optional[Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None, tp=None):
    """[B, S] token ids -> ([B, S, th] sequence, [B, S] mask); the backbone
    tensor-parallel under `tp` (a parallel/tensor.ModelGroup)."""
    with _frozen(params["text_backbone"]):
        seq = xlmr_mod.xlmr_encode(params["text_backbone"], cfg.text, input_ids,
                                   text_mask, deterministic=deterministic,
                                   generator=generator, remat=cfg.remat_encoders, tp=tp)
    seq = _adapter(params["text_adapter"], seq)
    if cfg.use_asr and asr_feats is not None:
        drop = (generator, deterministic)
        asr_p = _feature_proj(params["asr_proj"], asr_feats.to(seq.dtype), *drop)
        seq = _feature_fuse(params["asr_fusion"], seq, asr_p, *drop)
    return seq, text_mask


def frontend_features(cfg: ModelConfig, batch: dict):
    """(wave, quality_feats, cond_feats). Where the config enables the
    front-end DSP and the batch carries neither feature set, the DSP runs
    on the f32 waveform, on its device: the gates may zero clips, the
    conditioning filters what the encoder reads. Otherwise the features
    stay as the batch has them (None if absent)."""
    wave = batch["audio"]
    quality_feats = batch.get("quality_feats")
    cond_feats = batch.get("cond_feats")
    if (cfg.frontend_dsp and (cfg.use_quality_gates or cfg.use_audio_conditioning)
            and quality_feats is None and cond_feats is None):
        B = wave.shape[0]
        # without text, LID gives entropy 1.0 and confidence 0
        ent = batch.get("lid_entropy", torch.ones(B, device=wave.device))
        conf = batch.get("lid_conf", torch.zeros(B, device=wave.device))
        wave, quality_feats, cond_feats, _ = frontend_process(
            wave.float(), batch["audio_mask"].float(),
            lid_entropy=ent, lid_confidence=conf,
            use_gates=cfg.use_quality_gates,
            use_conditioning=cfg.use_audio_conditioning,
            zero_non_accept=cfg.zero_non_accept)
    return wave, quality_feats, cond_feats


def model_heads(params: dict, cfg: ModelConfig, a_seq: Tensor, a_mask: Tensor,
                t_seq: Tensor, t_mask: Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                use_openmax: bool = False, tp=None) -> ModelOutput:
    """Cross-modal attention -> pooling x2 -> gated fusion -> classifier,
    from encoded sequences; `params` is the raw (uncast) tree. Under `tp`
    (a parallel/tensor.ModelGroup) the cross-modal attention runs this
    rank's heads; pooling, fusion and the classifier are replicated."""
    dtype = _compute_dtype(cfg)
    p = {k: cast_floating(params[k], dtype) for k in _HEAD_KEYS}
    a_enh, t_enh = cma.cross_modal_attention(
        p["cross"], a_seq, t_seq, a_mask, t_mask, num_heads=cfg.num_heads,
        dropout_rate=cfg.cross_dropout, generator=generator, deterministic=deterministic,
        tp=tp)
    a_vec = pooling_ops.attentive_stats_pooling(p["pool_a"], a_enh, a_mask)
    t_vec = pooling_ops.attentive_stats_pooling(p["pool_t"], t_enh, t_mask)
    fused = fusion_mod.fusion(p["fusion"], a_vec, t_vec, dropout_rate=cfg.fusion_dropout,
                              generator=generator, deterministic=deterministic)
    # the classifier stays f32 on the raw parameters
    out = clf.classifier_forward(params["classifier"], fused.float(),
                                 use_openmax=use_openmax,
                                 dropout_rate=cfg.classifier_dropout,
                                 anchor_dropout=cfg.anchor_dropout,
                                 generator=generator, deterministic=deterministic)
    return ModelOutput(logits=out.logits, uncertainty=out.uncertainty,
                       anchor_loss=out.anchor_loss,
                       anchor_similarities=out.anchor_similarities,
                       features=out.features, fused=fused.float(),
                       audio_vec=a_vec, text_vec=t_vec)


def model_forward(params: dict, cfg: ModelConfig, batch: dict, *,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  use_openmax: bool = False,
                  spec_augment: bool = False, tp=None) -> ModelOutput:
    """batch: audio [B, T] f32, audio_mask [B, T], text_ids [B, S] ints,
    text_mask [B, S]; optional quality_feats [B, 8], cond_feats [B, 12],
    asr_feats [B, 8]. Tensors or numpy arrays; they go to the device the
    parameters live on. `deterministic=False` (training) draws dropout, and
    SpecAugment where `spec_augment`, from `generator`, which it needs.

    `tp` (a parallel/tensor.ModelGroup) is the tensor-parallel forward:
    `params` is this rank's view (parallel/tensor.local_params: the leaves
    the 'model' rule shards are this rank's shards), both encoders and the
    cross-modal attention split their heads and FFN columns over the
    group, and everything else, the classifier included, is replicated.
    Every rank of the group passes the same batch."""
    if not deterministic and generator is None:
        raise ValueError("model_forward: the training forward (deterministic=False) "
                         "needs a torch.Generator on the parameters' device")
    device = params["classifier"]["input_proj"]["kernel"].device
    batch = {k: to_device(v, device) for k, v in batch.items()}
    dtype = _compute_dtype(cfg)
    p = encoder_params(params, cfg)
    wave, quality_feats, cond_feats = frontend_features(cfg, batch)
    drop = dict(deterministic=deterministic, generator=generator, tp=tp)
    a_seq, a_mask = encode_audio(p, cfg, wave.to(dtype), batch["audio_mask"],
                                 quality_feats=quality_feats, cond_feats=cond_feats,
                                 spec_augment=spec_augment, **drop)
    t_seq, t_mask = encode_text(p, cfg, batch["text_ids"], batch["text_mask"],
                                asr_feats=batch.get("asr_feats"), **drop)
    return model_heads(params, cfg, a_seq, a_mask, t_seq, t_mask,
                       use_openmax=use_openmax, **drop)


def load_pretrained_backbones(params: dict, *, wav2vec2_state=None, xlmr_state=None) -> dict:
    """The parameters with their backbones replaced by converted Hugging Face
    state dicts (models/hf_convert.py; layer and conv counts read from the
    keys), on the parameters' device. A converted backbone must have the
    configured one's leaves and shapes, or this raises."""
    from . import hf_convert
    from .ref_convert import check_shapes
    device = params["classifier"]["input_proj"]["kernel"].device
    params = dict(params)
    for name, state, convert in (("audio_backbone", wav2vec2_state, hf_convert.wav2vec2_from_hf),
                                 ("text_backbone", xlmr_state, hf_convert.xlmr_from_hf)):
        if state is not None:
            tree = convert(state)
            check_shapes(name, params[name], tree)
            params[name] = tree_to(tree, device)
    return params
