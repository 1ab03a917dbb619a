"""Reference checkpoints (torch .pt) <-> the port's parameter tree.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/ref_convert.py. The reference's trainers save one flat torch dict
of 8 module state dicts plus optimizer, scheduler, epoch and f1
(train.py:247-263; train_crema.py and train_crema_final.py use the same
layout). The forward half maps every learned tensor of such a file into
the port's tree, so that the port's eval, infer, export and serve CLIs run
a migrated model; the inverse half writes the port's tree back in that
layout, loadable with `load_state_dict(strict=True)` by the reference's
own modules.

What maps where (reference module attribute -> the port's tree key):
  audio_encoder.encoder.*            -> audio_backbone   (hf_convert)
  audio_encoder.adapter.{0,2}        -> audio_adapter.{down,up}
  audio_encoder.{combined,quality,conditioning}_fusion.0
                                     -> {combined,quality,conditioning}_fusion.lin
  audio_encoder.quality_gates.quality_projection.{0,3}
                                     -> quality_proj.{lin1,lin2}
  audio_encoder.audio_conditioning.conditioning_projection.{0,3}
                                     -> cond_proj.{lin1,lin2}
  text_encoder.encoder.*             -> text_backbone    (hf_convert)
  text_encoder.adapter.{0,2}         -> text_adapter.{down,up}
  text_encoder.asr_fusion.0          -> asr_fusion.lin
  text_encoder.asr_integration.asr_projection.{0,3} (lazy; usually absent)
                                     -> asr_proj.{lin1,lin2}
  cross / pool_a / pool_t / fusion / prototypes -> the same-named subtrees
  classifier                         -> classifier (Weibull buffers included)

Not mapped, and reported as skipped: the encoders' own attentive pools
(`pool.*`, dead on every reference path; the live pools are pool_a and
pool_t) and the optimizer and scheduler state. The writer emits zeros for
what the reference needs and the port does not carry (those dead pools,
the sibling fusions that are dead beside combined_fusion, the XLM-R
pooler).

The arithmetic is the JAX package's, in numpy f32, so both packages read
and write the same numbers. Nothing here touches a device: the trees are
f32 CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig, Wav2Vec2Config, XLMRConfig
from ..utils.runtime import leaves_with_paths
from . import hf_convert

REFERENCE_MODULES = ("audio_encoder", "text_encoder", "cross", "pool_a", "pool_t",
                     "fusion", "classifier", "prototypes")

_np = hf_convert._np
_t = hf_convert._t


def _sub(sd: Mapping, prefix: str) -> dict:
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}


def _lin(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _t(_np(sd[f"{prefix}.weight"]).T), "bias": _t(_np(sd[f"{prefix}.bias"]))}


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(_np(sd[f"{prefix}.weight"])), "bias": _t(_np(sd[f"{prefix}.bias"]))}


def _mha(sd: Mapping, prefix: str) -> dict:
    """torch nn.MultiheadAttention's packed in_proj -> q/k/v/out linears."""
    w = _np(sd[f"{prefix}.in_proj_weight"])
    b = _np(sd[f"{prefix}.in_proj_bias"])
    E = w.shape[0] // 3
    out = {name: {"kernel": _t(w[i * E:(i + 1) * E].T), "bias": _t(b[i * E:(i + 1) * E])}
           for i, name in enumerate(("q", "k", "v"))}
    out["out"] = _lin(sd, f"{prefix}.out_proj")
    return out


def _proj(sd: Mapping, prefix: str) -> dict:
    """Sequential(Linear(d, 32), ReLU, Dropout, Linear(32, d))."""
    return {"lin1": _lin(sd, f"{prefix}.0"), "lin2": _lin(sd, f"{prefix}.3")}


def cross_from_ref(sd: Mapping) -> dict:
    """CrossModalAttention's state dict."""
    out = {name: _lin(sd, name) for name in ("q_a", "k_t", "v_t")}
    out["attn_a"] = _mha(sd, "attn_a")
    out["out_a"] = _lin(sd, "out_a")
    out.update({name: _lin(sd, name) for name in ("q_t", "k_a", "v_a")})
    out["attn_t"] = _mha(sd, "attn_t")
    out["out_t"] = _lin(sd, "out_t")
    out["norm_a"] = _ln(sd, "norm_a")
    out["norm_t"] = _ln(sd, "norm_t")
    return out


def pool_from_ref(sd: Mapping) -> dict:
    """AttentiveStatsPooling's state dict."""
    return {"w1": _lin(sd, "attention.0"), "w2": _lin(sd, "attention.2")}


_FUSION = (("proj_a1", "proj_a.0"), ("proj_a2", "proj_a.3"),
           ("proj_t1", "proj_t.0"), ("proj_t2", "proj_t.3"),
           ("gate_a1", "gate_a.0"), ("gate_a2", "gate_a.2"),
           ("gate_t1", "gate_t.0"), ("gate_t2", "gate_t.2"))


def fusion_from_ref(sd: Mapping) -> dict:
    """FusionLayer's state dict."""
    return {ours: _lin(sd, ref) for ours, ref in _FUSION}


def _n_residual(sd: Mapping) -> int:
    return 1 + max(int(k.split(".")[2]) for k in sd
                   if k.startswith("deep_classifier.residual_layers."))


def classifier_from_ref(sd: Mapping) -> dict:
    """AdvancedOpenMaxClassifier's state dict -> the stacked tree (block
    Sequential indices: 0 LN, 1 Linear, 4 Linear; one extra LN per layer in
    deep_classifier.layer_norms), the Weibull buffers included."""
    per_layer = []
    for i in range(_n_residual(sd)):
        blk = f"deep_classifier.residual_layers.{i}.block"
        per_layer.append({"ln_pre": _ln(sd, f"deep_classifier.layer_norms.{i}"),
                          "block_ln": _ln(sd, f"{blk}.0"),
                          "block_lin1": _lin(sd, f"{blk}.1"),
                          "block_lin2": _lin(sd, f"{blk}.4")})
    stacked = {outer: {inner: torch.stack([p[outer][inner] for p in per_layer])
                       for inner in per_layer[0][outer]} for outer in per_layer[0]}
    return {
        "input_proj": _lin(sd, "deep_classifier.input_projection.0"),
        "input_ln": _ln(sd, "deep_classifier.input_projection.1"),
        "layers": stacked,
        "out_proj1": _lin(sd, "deep_classifier.output_projection.0"),
        "out_ln": _ln(sd, "deep_classifier.output_projection.1"),
        "out_proj2": _lin(sd, "deep_classifier.output_projection.4"),
        "anchor": {"class_anchors": _t(_np(sd["anchor_clustering.class_anchors"])),
                   "projection": _lin(sd, "anchor_clustering.anchor_projection.0"),
                   "proj_ln": _ln(sd, "anchor_clustering.anchor_projection.1"),
                   "temperature": _t(_np(sd["anchor_clustering.temperature"]))},
        "uncertainty": {"lin1": _lin(sd, "uncertainty_head.0"),
                        "lin2": _lin(sd, "uncertainty_head.3")},
        "weibull": {"alpha": _t(_np(sd["weibull_alpha"])),
                    "beta": _t(_np(sd["weibull_beta"])),
                    "tau": _t(_np(sd["weibull_tau"])),
                    "activation_vectors": _t(_np(sd["activation_vectors"]))},
    }


def _snap_heads(hidden: int, base_hidden: int, base_heads: int) -> int:
    """Head counts do not show in the shapes (q/k/v are [H, H] whatever the
    count): base's where the width matches, else the family rule (12 below
    1024, 16 from 1024 on), snapped down to a divisor of `hidden`."""
    if hidden == base_hidden:
        return base_heads
    h = min(16 if hidden >= 1024 else 12, hidden)
    while hidden % h:
        h -= 1
    return h


def _n_layers(sd: Mapping, prefix: str) -> int:
    return 1 + max(int(k.split(".")[2]) for k in sd if k.startswith(prefix))


def infer_model_config(ckpt: Mapping, base_cfg: Optional[ModelConfig] = None) -> ModelConfig:
    """The ModelConfig a reference checkpoint's shapes and keys imply; what
    they do not show (dropout rates, ...) stays `base_cfg`'s (default
    ModelConfig). Per-conv LayerNorms mean the layer-norm extractor,
    `rel_attn_embed` WavLM's gated bias, hidden 1024 the stable pre-LN
    encoder every large checkpoint uses. Strides and head counts are not
    in the shapes: the family's (cli/import_checkpoint.py reports them and
    takes overrides)."""
    base = base_cfg if base_cfg is not None else ModelConfig()
    a_sd, t_sd, c_sd = ckpt["audio_encoder"], ckpt["text_encoder"], ckpt["classifier"]

    a_bb = _sub(a_sd, "encoder")
    conv_kernels = []
    while f"feature_extractor.conv_layers.{len(conv_kernels)}.conv.weight" in a_bb:
        conv_kernels.append(
            _np(a_bb[f"feature_extractor.conv_layers.{len(conv_kernels)}.conv.weight"]))
    ah = int(_np(a_bb["encoder.layers.0.attention.q_proj.weight"]).shape[0])
    pos_w = hf_convert.pos_conv_weight(a_bb, "encoder.pos_conv_embed.conv")
    n_convs = len(conv_kernels)
    audio = Wav2Vec2Config(
        conv_dim=tuple(int(w.shape[0]) for w in conv_kernels),
        conv_kernel=tuple(int(w.shape[2]) for w in conv_kernels),
        conv_stride=(base.audio.conv_stride[:n_convs]
                     + (2,) * max(0, n_convs - len(base.audio.conv_stride))),
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in a_bb,
        hidden_size=ah, num_hidden_layers=_n_layers(a_bb, "encoder.layers."),
        num_attention_heads=_snap_heads(ah, base.audio.hidden_size,
                                        base.audio.num_attention_heads),
        intermediate_size=int(_np(
            a_bb["encoder.layers.0.feed_forward.intermediate_dense.weight"]).shape[0]),
        num_conv_pos_embeddings=int(pos_w.shape[2]),
        num_conv_pos_embedding_groups=ah // int(pos_w.shape[1]),
        do_stable_layer_norm=(base.audio.do_stable_layer_norm
                              if ah == base.audio.hidden_size else ah >= 1024),
        feat_extract_norm=("layer" if "feature_extractor.conv_layers.1.layer_norm.weight"
                           in a_bb else "group"),
        gated_relpos_bias=any("rel_attn_embed" in k for k in a_bb))

    t_bb = _sub(t_sd, "encoder")
    emb = _np(t_bb["embeddings.word_embeddings.weight"])
    th = int(emb.shape[1])
    text = XLMRConfig(
        vocab_size=int(emb.shape[0]), hidden_size=th,
        num_hidden_layers=_n_layers(t_bb, "encoder.layer."),
        num_attention_heads=_snap_heads(th, base.text.hidden_size,
                                        base.text.num_attention_heads),
        intermediate_size=int(_np(t_bb["encoder.layer.0.intermediate.dense.weight"]).shape[0]),
        max_position_embeddings=int(_np(
            t_bb["embeddings.position_embeddings.weight"]).shape[0]))

    in_w = _np(c_sd["deep_classifier.input_projection.0.weight"])
    return dataclasses.replace(
        base,
        num_labels=int(_np(c_sd["deep_classifier.output_projection.4.weight"]).shape[0]),
        adapter_dim=int(_np(a_sd["adapter.0.weight"]).shape[0]),
        shared_dim=int(_np(ckpt["cross"]["q_a.weight"]).shape[0]),
        proj_dim=int(in_w.shape[1]),
        classifier_layers=_n_residual(c_sd),
        classifier_base_dim=int(in_w.shape[0]),
        use_quality_gates=any(k.startswith(("quality_fusion.", "combined_fusion."))
                              for k in a_sd),
        use_audio_conditioning=any(k.startswith(("conditioning_fusion.", "combined_fusion."))
                                   for k in a_sd),
        audio=audio, text=text)


def check_shapes(name: str, template, value) -> None:
    """Raise unless `value` has exactly `template`'s leaves, shape for shape."""
    want = dict(leaves_with_paths(template))
    have = dict(leaves_with_paths(value))
    for path, leaf in want.items():
        if path not in have:
            raise ValueError(f"{name}: the converted tree has no leaf {path}")
        if tuple(have[path].shape) != tuple(leaf.shape):
            raise ValueError(
                f"{name}/{path}: shape {tuple(have[path].shape)} != expected "
                f"{tuple(leaf.shape)}: the checkpoint does not match the model config "
                "(pass or infer a matching config)")
    extra = sorted(set(have) - set(want))
    if extra:
        raise ValueError(f"{name}: the converted tree has unexpected leaves {extra[:3]}")


_AE_FUSIONS = ("combined_fusion", "quality_fusion", "conditioning_fusion")


def params_from_reference_checkpoint(ckpt: Mapping, cfg: ModelConfig, init_params: dict):
    """(params, report): a copy of `init_params` with every subtree the
    checkpoint carries replaced by its tensors (f32, CPU). The report lists
    the subtrees imported, those left at their initialisation (asr_proj
    where the reference never built its lazy ASR module) and the reference
    tensors skipped, with the checkpoint's epoch and f1. A shape that does
    not match `init_params` raises."""
    params = dict(init_params)
    imported = []
    a_sd, t_sd = ckpt["audio_encoder"], ckpt["text_encoder"]
    a_used, t_used = ["encoder.", "adapter."], ["encoder.", "adapter."]

    def put(name: str, value) -> None:
        check_shapes(name, init_params[name], value)
        params[name] = value
        imported.append(name)

    put("audio_backbone", hf_convert.wav2vec2_from_hf(_sub(a_sd, "encoder")))
    put("audio_adapter", {"down": _lin(a_sd, "adapter.0"), "up": _lin(a_sd, "adapter.2")})
    put("text_backbone", hf_convert.xlmr_from_hf(_sub(t_sd, "encoder")))
    put("text_adapter", {"down": _lin(t_sd, "adapter.0"), "up": _lin(t_sd, "adapter.2")})
    put("cross", cross_from_ref(ckpt["cross"]))
    put("pool_a", pool_from_ref(ckpt["pool_a"]))
    put("pool_t", pool_from_ref(ckpt["pool_t"]))
    put("fusion", fusion_from_ref(ckpt["fusion"]))
    put("classifier", classifier_from_ref(ckpt["classifier"]))
    put("prototypes", {"prototypes": _t(_np(ckpt["prototypes"]["prototypes"]))})
    for name in _AE_FUSIONS:
        if name in init_params and f"{name}.0.weight" in a_sd:
            put(name, {"lin": _lin(a_sd, f"{name}.0")})
            a_used.append(f"{name}.")
    if "asr_fusion.0.weight" in t_sd:
        put("asr_fusion", {"lin": _lin(t_sd, "asr_fusion.0")})
        t_used.append("asr_fusion.")
    for ours, sd, ref, used in (
            ("quality_proj", a_sd, "quality_gates.quality_projection", a_used),
            ("cond_proj", a_sd, "audio_conditioning.conditioning_projection", a_used)):
        if ours in init_params and f"{ref}.0.weight" in sd:
            put(ours, _proj(sd, ref))
            used.append(f"{ref}.")
    if "asr_integration.asr_projection.0.weight" in t_sd:
        put("asr_proj", _proj(t_sd, "asr_integration.asr_projection"))
        t_used.append("asr_integration.asr_projection.")

    skipped = sorted(
        {f"audio_encoder.{k}" for k in a_sd if not k.startswith(tuple(a_used))}
        | {f"text_encoder.{k}" for k in t_sd if not k.startswith(tuple(t_used))}
        | ({"optimizer", "scheduler"} & set(ckpt)))
    report = {"imported": sorted(imported),
              "left_at_init": sorted(set(init_params) - set(imported)),
              "skipped": skipped,
              "epoch": int(ckpt.get("epoch", 0)),
              "f1": float(ckpt.get("f1", 0.0))}
    return params, report


def load_reference_checkpoint(path: str) -> dict:
    """torch.load a reference .pt on the CPU (weights only where it can)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# the inverse: the port's tree -> the reference's state dicts
# ---------------------------------------------------------------------------

def _lin_inv(dst: dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _t(_np(p["kernel"]).T)
    if "bias" in p:
        dst[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _ln_inv(dst: dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _t(_np(p["scale"]))
    dst[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _mha_inv(dst: dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.in_proj_weight"] = torch.cat([_t(_np(p[k]["kernel"]).T)
                                                 for k in ("q", "k", "v")])
    dst[f"{prefix}.in_proj_bias"] = torch.cat([_t(_np(p[k]["bias"])) for k in ("q", "k", "v")])
    _lin_inv(dst, f"{prefix}.out_proj", p["out"])


def _proj_inv(dst: dict, prefix: str, p: Mapping) -> None:
    _lin_inv(dst, f"{prefix}.0", p["lin1"])
    _lin_inv(dst, f"{prefix}.3", p["lin2"])


def _zero_linear(dst: dict, prefix: str, in_dim: int, out_dim: int) -> None:
    dst[f"{prefix}.weight"] = torch.zeros(out_dim, in_dim)
    dst[f"{prefix}.bias"] = torch.zeros(out_dim)


def _dead_pool(dst: dict, hidden: int) -> None:
    """Zeros for an encoder's own attentive pool, which the reference
    builds and never runs, so that a strict load succeeds."""
    _zero_linear(dst, "pool.attention.0", hidden, 128)
    _zero_linear(dst, "pool.attention.2", 128, 1)


def _layer(stacked, i: int):
    if isinstance(stacked, Mapping):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_stacked(stacked: Mapping) -> int:
    return int(stacked["attn_ln"]["scale"].shape[0])


POS_CONV_STYLES = ("parametrizations", "weight_norm", "plain")


def wav2vec2_to_hf(tree: Mapping, *, pos_conv_style: str = "parametrizations") -> dict:
    """Inverse of hf_convert.wav2vec2_from_hf. `pos_conv_style` picks how the
    positional conv's weight norm is written: torch's parametrizations
    (torch >= 2.1), the legacy weight_g / weight_v, or a plain weight
    (loads only into a module without weight norm)."""
    if pos_conv_style not in POS_CONV_STYLES:
        raise ValueError(f"unknown pos_conv_style {pos_conv_style!r}")
    sd: dict = {}
    layer_norm_convs = "ln" in tree["convs"][0]
    for i, c in enumerate(tree["convs"]):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = _t(_np(c["kernel"]))
        if "bias" in c:
            sd[f"{pre}.conv.bias"] = _t(_np(c["bias"]))
        if layer_norm_convs:
            _ln_inv(sd, f"{pre}.layer_norm", c["ln"])
    if not layer_norm_convs:
        _ln_inv(sd, "feature_extractor.conv_layers.0.layer_norm", tree["group_norm"])
    _ln_inv(sd, "feature_projection.layer_norm", tree["feat_proj"]["ln"])
    _lin_inv(sd, "feature_projection.projection", tree["feat_proj"]["proj"])

    w = _np(tree["pos_conv"]["kernel"])  # [H, H/groups, K]
    pre = "encoder.pos_conv_embed.conv"
    if pos_conv_style == "plain":
        sd[f"{pre}.weight"] = _t(w)
    else:
        # weight = g * v / ||v||: v = w, g = ||w|| over dims 0 and 1
        g = np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))
        names = (("parametrizations.weight.original0", "parametrizations.weight.original1")
                 if pos_conv_style == "parametrizations" else ("weight_g", "weight_v"))
        sd[f"{pre}.{names[0]}"] = _t(g)
        sd[f"{pre}.{names[1]}"] = _t(w)
    sd[f"{pre}.bias"] = _t(_np(tree["pos_conv"]["bias"]))
    _ln_inv(sd, "encoder.layer_norm", tree["encoder_ln"])
    sd["masked_spec_embed"] = _t(_np(tree["masked_spec_embed"]))

    stacked = tree["layers"]
    wavlm = "gru_lin" in stacked
    for i in range(_n_stacked(stacked)):
        layer = _layer(stacked, i)
        pre = f"encoder.layers.{i}"
        for ours, ref in (("q", "attention.q_proj"), ("k", "attention.k_proj"),
                          ("v", "attention.v_proj"), ("out", "attention.out_proj")):
            _lin_inv(sd, f"{pre}.{ref}", layer[ours])
        _ln_inv(sd, f"{pre}.layer_norm", layer["attn_ln"])
        _lin_inv(sd, f"{pre}.feed_forward.intermediate_dense", layer["ffn_in"])
        _lin_inv(sd, f"{pre}.feed_forward.output_dense", layer["ffn_out"])
        _ln_inv(sd, f"{pre}.final_layer_norm", layer["final_ln"])
        if wavlm:
            _lin_inv(sd, f"{pre}.attention.gru_rel_pos_linear", layer["gru_lin"])
            sd[f"{pre}.attention.gru_rel_pos_const"] = _t(
                _np(layer["gru_const"]).reshape(1, -1, 1, 1))
    if wavlm:
        sd["encoder.layers.0.attention.rel_attn_embed.weight"] = _t(
            _np(tree["rel_attn_embed"]))
    return sd


def xlmr_to_hf(tree: Mapping, *, include_pooler: bool = True) -> dict:
    """Inverse of hf_convert.xlmr_from_hf; `include_pooler` adds the zeroed
    pooler XLMRobertaModel registers by default (the reference reads only
    the last hidden state)."""
    sd: dict = {}
    emb = tree["embeddings"]
    sd["embeddings.word_embeddings.weight"] = _t(_np(emb["word"]))
    sd["embeddings.position_embeddings.weight"] = _t(_np(emb["position"]))
    sd["embeddings.token_type_embeddings.weight"] = _t(_np(emb["token_type"]))
    _ln_inv(sd, "embeddings.LayerNorm", emb["ln"])
    stacked = tree["layers"]
    for i in range(_n_stacked(stacked)):
        layer = _layer(stacked, i)
        pre = f"encoder.layer.{i}"
        for ours, ref in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("out", "attention.output.dense")):
            _lin_inv(sd, f"{pre}.{ref}", layer[ours])
        _ln_inv(sd, f"{pre}.attention.output.LayerNorm", layer["attn_ln"])
        _lin_inv(sd, f"{pre}.intermediate.dense", layer["ffn_in"])
        _lin_inv(sd, f"{pre}.output.dense", layer["ffn_out"])
        _ln_inv(sd, f"{pre}.output.LayerNorm", layer["final_ln"])
    if include_pooler:
        H = int(emb["word"].shape[1])
        _zero_linear(sd, "pooler.dense", H, H)
    return sd


def reference_state_dicts_from_params(params: Mapping, cfg: ModelConfig, *,
                                      pos_conv_style: str = "parametrizations",
                                      include_pooler: bool = True) -> dict:
    """The port's tree -> the reference trainers' 8 state dicts. Zeros for
    the tensors the reference needs and the tree does not carry (the
    encoders' dead pools; beside combined_fusion, the dead sibling
    fusions). asr_proj is not written: the reference builds its ASR module
    only after construction, so a strict load would refuse the keys."""
    a_sd = {f"encoder.{k}": v for k, v in
            wav2vec2_to_hf(params["audio_backbone"], pos_conv_style=pos_conv_style).items()}
    _lin_inv(a_sd, "adapter.0", params["audio_adapter"]["down"])
    _lin_inv(a_sd, "adapter.2", params["audio_adapter"]["up"])
    hid = cfg.audio_hidden
    _dead_pool(a_sd, hid)
    if "quality_proj" in params:
        _proj_inv(a_sd, "quality_gates.quality_projection", params["quality_proj"])
    if "cond_proj" in params:
        _proj_inv(a_sd, "audio_conditioning.conditioning_projection", params["cond_proj"])
    if cfg.use_quality_gates and cfg.use_audio_conditioning:
        _lin_inv(a_sd, "combined_fusion.0", params["combined_fusion"]["lin"])
        _zero_linear(a_sd, "quality_fusion.0", hid + 8, hid)
        _zero_linear(a_sd, "conditioning_fusion.0", hid + 12, hid)
    elif cfg.use_quality_gates:
        _lin_inv(a_sd, "quality_fusion.0", params["quality_fusion"]["lin"])
    elif cfg.use_audio_conditioning:
        _lin_inv(a_sd, "conditioning_fusion.0", params["conditioning_fusion"]["lin"])

    t_sd = {f"encoder.{k}": v for k, v in
            xlmr_to_hf(params["text_backbone"], include_pooler=include_pooler).items()}
    _lin_inv(t_sd, "adapter.0", params["text_adapter"]["down"])
    _lin_inv(t_sd, "adapter.2", params["text_adapter"]["up"])
    _dead_pool(t_sd, cfg.text_hidden)
    _lin_inv(t_sd, "asr_fusion.0", params["asr_fusion"]["lin"])

    cross_sd: dict = {}
    cp = params["cross"]
    for name in ("q_a", "k_t", "v_t", "out_a", "q_t", "k_a", "v_a", "out_t"):
        _lin_inv(cross_sd, name, cp[name])
    _mha_inv(cross_sd, "attn_a", cp["attn_a"])
    _mha_inv(cross_sd, "attn_t", cp["attn_t"])
    _ln_inv(cross_sd, "norm_a", cp["norm_a"])
    _ln_inv(cross_sd, "norm_t", cp["norm_t"])

    def pool_sd(p: Mapping) -> dict:
        d: dict = {}
        _lin_inv(d, "attention.0", p["w1"])
        _lin_inv(d, "attention.2", p["w2"])
        return d

    fusion_sd: dict = {}
    for ours, ref in _FUSION:
        _lin_inv(fusion_sd, ref, params["fusion"][ours])

    clf_sd: dict = {}
    c = params["classifier"]
    _lin_inv(clf_sd, "deep_classifier.input_projection.0", c["input_proj"])
    _ln_inv(clf_sd, "deep_classifier.input_projection.1", c["input_ln"])
    for i in range(int(c["layers"]["ln_pre"]["scale"].shape[0])):
        layer = _layer(c["layers"], i)
        _ln_inv(clf_sd, f"deep_classifier.layer_norms.{i}", layer["ln_pre"])
        blk = f"deep_classifier.residual_layers.{i}.block"
        _ln_inv(clf_sd, f"{blk}.0", layer["block_ln"])
        _lin_inv(clf_sd, f"{blk}.1", layer["block_lin1"])
        _lin_inv(clf_sd, f"{blk}.4", layer["block_lin2"])
    _lin_inv(clf_sd, "deep_classifier.output_projection.0", c["out_proj1"])
    _ln_inv(clf_sd, "deep_classifier.output_projection.1", c["out_ln"])
    _lin_inv(clf_sd, "deep_classifier.output_projection.4", c["out_proj2"])
    anc = c["anchor"]
    clf_sd["anchor_clustering.class_anchors"] = _t(_np(anc["class_anchors"]))
    _lin_inv(clf_sd, "anchor_clustering.anchor_projection.0", anc["projection"])
    _ln_inv(clf_sd, "anchor_clustering.anchor_projection.1", anc["proj_ln"])
    clf_sd["anchor_clustering.temperature"] = _t(_np(anc["temperature"]))
    _lin_inv(clf_sd, "uncertainty_head.0", c["uncertainty"]["lin1"])
    _lin_inv(clf_sd, "uncertainty_head.3", c["uncertainty"]["lin2"])
    wb = c["weibull"]
    for ref, ours in (("weibull_alpha", "alpha"), ("weibull_beta", "beta"),
                      ("weibull_tau", "tau"), ("activation_vectors", "activation_vectors")):
        clf_sd[ref] = _t(_np(wb[ours]))

    return {"audio_encoder": a_sd, "text_encoder": t_sd, "cross": cross_sd,
            "pool_a": pool_sd(params["pool_a"]), "pool_t": pool_sd(params["pool_t"]),
            "fusion": fusion_sd, "classifier": clf_sd,
            "prototypes": {"prototypes": _t(_np(params["prototypes"]["prototypes"]))}}
