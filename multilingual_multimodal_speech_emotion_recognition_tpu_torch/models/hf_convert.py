"""Hugging Face state dicts -> the port's parameter trees.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/hf_convert.py: the state dicts of `Wav2Vec2Model`, `HubertModel`,
`WavLMModel` (`wav2vec2_from_hf`), `Wav2Vec2BertModel` (w2v-BERT 2.0,
`w2v_bert_from_hf`; the JAX package has none) and `XLMRobertaModel` /
`RobertaModel` (`xlmr_from_hf`) become the trees that models/wav2vec2.py,
models/w2v_bert.py and models/xlmr.py read (`audio_from_hf` picks the
audio converter by the keys), which is how the reference loads its frozen
pretrained backbones (`from_pretrained`). The input is any mapping of
names to torch tensors or numpy arrays (a live module's `state_dict()`,
or a dict of arrays); transformers is never imported.

The variant is read from the keys: a LayerNorm on conv layer 1 means the
layer-norm extractor (wav2vec2-large, HuBERT-Large, WavLM-Large; conv 0's
"layer_norm" is the group norm otherwise), `rel_attn_embed` on layer 0
means WavLM (its gate tensors on every layer). The encoder's layer order
(do_stable_layer_norm) leaves no trace in the keys: the config sets it.

Written straight in the port's layout (models/layers.py): conv kernels
stay torch's [C_out, C_in/groups, K], linear kernels go from [out, in] to
[in, out], layers are stacked [L, ...]. The arithmetic is the JAX
package's, in numpy f32 (the positional conv's weight norm included), so
both packages hold the same numbers; the leaves are f32 CPU tensors.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _lin(sd: Mapping, prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def pos_conv_weight(sd: Mapping, prefix: str) -> np.ndarray:
    """The positional conv's weight [H, H/groups, K], materialised from its
    weight norm (over dims 0 and 1) where the state dict keeps one: torch's
    `parametrizations.weight.original0/1`, the legacy `weight_g/weight_v`,
    or a plain `weight`."""
    if f"{prefix}.weight" in sd:
        return _np(sd[f"{prefix}.weight"])
    if f"{prefix}.parametrizations.weight.original0" in sd:
        g = _np(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _np(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        g = _np(sd[f"{prefix}.weight_g"])
        v = _np(sd[f"{prefix}.weight_v"])
    norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _count(sd: Mapping, pattern: str) -> int:
    i = 0
    while pattern.format(i) in sd:
        i += 1
    return i


def _stack(per_layer: list) -> dict:
    """[{name: {leaf: array} | array}] -> {name: {leaf: [L, ...]} | [L, ...]}."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in per_layer]) for k in first}
    return np.stack(per_layer)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return _t(tree)


def wav2vec2_from_hf(state_dict: Mapping, num_layers: Optional[int] = None,
                     num_convs: Optional[int] = None) -> dict:
    """The audio backbone's tree from a Wav2Vec2Model / HubertModel /
    WavLMModel state dict (counts read from the keys unless given)."""
    sd = dict(state_dict)
    if num_convs is None:
        num_convs = _count(sd, "feature_extractor.conv_layers.{}.conv.weight")
    if num_layers is None:
        num_layers = _count(sd, "encoder.layers.{}.final_layer_norm.weight")
    layer_norm_convs = "feature_extractor.conv_layers.1.layer_norm.weight" in sd
    wavlm = "encoder.layers.0.attention.rel_attn_embed.weight" in sd

    convs = []
    for i in range(num_convs):
        conv = _conv(sd, f"feature_extractor.conv_layers.{i}.conv")
        if layer_norm_convs:
            conv["ln"] = _ln(sd, f"feature_extractor.conv_layers.{i}.layer_norm")
        convs.append(conv)

    def layer(i: int) -> dict:
        pre = f"encoder.layers.{i}"
        p = {
            "q": _lin(sd, f"{pre}.attention.q_proj"),
            "k": _lin(sd, f"{pre}.attention.k_proj"),
            "v": _lin(sd, f"{pre}.attention.v_proj"),
            "out": _lin(sd, f"{pre}.attention.out_proj"),
            "attn_ln": _ln(sd, f"{pre}.layer_norm"),
            "ffn_in": _lin(sd, f"{pre}.feed_forward.intermediate_dense"),
            "ffn_out": _lin(sd, f"{pre}.feed_forward.output_dense"),
            "final_ln": _ln(sd, f"{pre}.final_layer_norm"),
        }
        if wavlm:
            p["gru_lin"] = _lin(sd, f"{pre}.attention.gru_rel_pos_linear")
            # torch keeps it [1, H, 1, 1]
            p["gru_const"] = _np(sd[f"{pre}.attention.gru_rel_pos_const"]).reshape(-1)
        return p

    params = {
        "convs": convs,
        "feat_proj": {"ln": _ln(sd, "feature_projection.layer_norm"),
                      "proj": _lin(sd, "feature_projection.projection")},
        "pos_conv": {"kernel": pos_conv_weight(sd, "encoder.pos_conv_embed.conv"),
                     "bias": _np(sd["encoder.pos_conv_embed.conv.bias"])},
        "encoder_ln": _ln(sd, "encoder.layer_norm"),
        "layers": _stack([layer(i) for i in range(num_layers)]),
    }
    params["masked_spec_embed"] = (
        _np(sd["masked_spec_embed"]) if "masked_spec_embed" in sd
        else np.zeros(params["feat_proj"]["proj"]["kernel"].shape[1], np.float32))
    if not layer_norm_convs:
        params["group_norm"] = _ln(sd, "feature_extractor.conv_layers.0.layer_norm")
    if wavlm:
        params["rel_attn_embed"] = _np(sd["encoder.layers.0.attention.rel_attn_embed.weight"])
    return _tensors(params)


def w2v_bert_from_hf(state_dict: Mapping, num_layers: Optional[int] = None) -> dict:
    """The audio backbone's tree (models/w2v_bert.py) from a
    Wav2Vec2BertModel state dict without adapter: the pointwise convs'
    [out, in, 1] weights become [in, out] kernels, the depthwise conv's
    [C, 1, K] its taps [K, C], each layer's distance embedding stacked."""
    sd = dict(state_dict)
    if num_layers is None:
        num_layers = _count(sd, "encoder.layers.{}.final_layer_norm.weight")

    def layer(i: int) -> dict:
        pre = f"encoder.layers.{i}"
        conv = f"{pre}.conv_module"
        p = {"ffn1_ln": _ln(sd, f"{pre}.ffn1_layer_norm"),
             "ffn1_in": _lin(sd, f"{pre}.ffn1.intermediate_dense"),
             "ffn1_out": _lin(sd, f"{pre}.ffn1.output_dense"),
             "attn_ln": _ln(sd, f"{pre}.self_attn_layer_norm")}
        for name in ("q", "k", "v", "out"):
            p[name] = _lin(sd, f"{pre}.self_attn.linear_{name}")
        p.update({
            "rel_attn_embed": _np(sd[f"{pre}.self_attn.distance_embedding.weight"]),
            "conv_ln": _ln(sd, f"{conv}.layer_norm"),
            "pointwise_in": {"kernel": _np(sd[f"{conv}.pointwise_conv1.weight"])[:, :, 0].T},
            "depthwise": {"kernel": _np(sd[f"{conv}.depthwise_conv.weight"])[:, 0, :].T},
            "depthwise_ln": _ln(sd, f"{conv}.depthwise_layer_norm"),
            "pointwise_out": {"kernel": _np(sd[f"{conv}.pointwise_conv2.weight"])[:, :, 0].T},
            "ffn2_ln": _ln(sd, f"{pre}.ffn2_layer_norm"),
            "ffn2_in": _lin(sd, f"{pre}.ffn2.intermediate_dense"),
            "ffn2_out": _lin(sd, f"{pre}.ffn2.output_dense"),
            "final_ln": _ln(sd, f"{pre}.final_layer_norm")})
        return p

    params = {"feat_proj": {"ln": _ln(sd, "feature_projection.layer_norm"),
                            "proj": _lin(sd, "feature_projection.projection")},
              "layers": _stack([layer(i) for i in range(num_layers)])}
    params["masked_spec_embed"] = (
        _np(sd["masked_spec_embed"]) if "masked_spec_embed" in sd
        else np.zeros(params["feat_proj"]["proj"]["kernel"].shape[1], np.float32))
    return _tensors(params)


def audio_from_hf(state_dict: Mapping) -> dict:
    """`w2v_bert_from_hf` for a state dict with a conformer conv module,
    `wav2vec2_from_hf` otherwise."""
    if "encoder.layers.0.conv_module.depthwise_conv.weight" in state_dict:
        return w2v_bert_from_hf(state_dict)
    return wav2vec2_from_hf(state_dict)


def xlmr_from_hf(state_dict: Mapping, num_layers: Optional[int] = None) -> dict:
    """The text backbone's tree from an XLMRobertaModel / RobertaModel state
    dict (a `roberta.` prefix is dropped; the pooler is not read)."""
    sd = {k.removeprefix("roberta."): v for k, v in dict(state_dict).items()}
    if num_layers is None:
        num_layers = _count(sd, "encoder.layer.{}.output.LayerNorm.weight")
    emb = {"word": _np(sd["embeddings.word_embeddings.weight"]),
           "position": _np(sd["embeddings.position_embeddings.weight"]),
           "token_type": _np(sd["embeddings.token_type_embeddings.weight"]),
           "ln": _ln(sd, "embeddings.LayerNorm")}

    def layer(i: int) -> dict:
        pre = f"encoder.layer.{i}"
        return {
            "q": _lin(sd, f"{pre}.attention.self.query"),
            "k": _lin(sd, f"{pre}.attention.self.key"),
            "v": _lin(sd, f"{pre}.attention.self.value"),
            "out": _lin(sd, f"{pre}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{pre}.attention.output.LayerNorm"),
            "ffn_in": _lin(sd, f"{pre}.intermediate.dense"),
            "ffn_out": _lin(sd, f"{pre}.output.dense"),
            "final_ln": _ln(sd, f"{pre}.output.LayerNorm"),
        }

    return _tensors({"embeddings": emb,
                     "layers": _stack([layer(i) for i in range(num_layers)])})
