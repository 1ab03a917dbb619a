"""XLM-RoBERTa text encoder: word + position + token-type row 0
embeddings with RoBERTa's pad-offset position ids, then post-LN layers with
an additive -inf mask on padded keys. Returns the last hidden state. In
training the JAX package's dropout sites apply (after the embedding LN;
attention weights, attention output and FFN output in each layer).

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/xlmr.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import XLMRConfig
from . import layers, remat as remat_lib

Tensor = torch.Tensor


def init_xlmr(init: layers.Init, cfg: XLMRConfig) -> dict:
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    L = (cfg.num_hidden_layers,)
    lin = lambda i, o: layers.init_normal_linear(init, i, o, 0.02, stack=L)
    return {
        "embeddings": {
            "word": init.normal((cfg.vocab_size, h), 0.02),
            "position": init.normal((cfg.max_position_embeddings, h), 0.02),
            "token_type": init.normal((cfg.type_vocab_size, h), 0.02),
            "ln": layers.init_layer_norm(init, h),
        },
        "layers": {
            "q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
            "attn_ln": layers.init_layer_norm(init, h, stack=L),
            "ffn_in": lin(h, ffn), "ffn_out": lin(ffn, h),
            "final_ln": layers.init_layer_norm(init, h, stack=L),
        },
    }


def position_ids_from_input_ids(input_ids: Tensor, pad_token_id: int) -> Tensor:
    """Positions count non-pad tokens only and are offset by pad_token_id."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


def xlmr_encode(params: dict, cfg: XLMRConfig, input_ids: Tensor,
                attention_mask: Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                remat: remat_lib.RematSpec = False, tp=None) -> Tensor:
    """input_ids: [B, S] ints; attention_mask: [B, S] (1 valid).
    Returns the last hidden state [B, S, hidden_size]. Under `tp` (a
    parallel/tensor.ModelGroup) the layers run tensor-parallel on this
    rank's shards; the embeddings are replicated."""
    emb = params["embeddings"]
    ids = input_ids.to(torch.int64)
    pos_ids = position_ids_from_input_ids(ids, cfg.pad_token_id)
    h = emb["word"][ids] + emb["position"][pos_ids] + emb["token_type"][0][None, None, :]
    h = layers.layer_norm(emb["ln"], h, eps=cfg.layer_norm_eps)
    h = layers.dropout(generator, h, cfg.hidden_dropout, deterministic)
    return layers.encoder_stack(
        params["layers"], h, layers.key_mask_bias(attention_mask),
        num_heads=cfg.num_attention_heads, eps=cfg.layer_norm_eps,
        attention_dropout=cfg.attention_dropout, hidden_dropout=cfg.hidden_dropout,
        generator=generator, deterministic=deterministic, remat=remat, tp=tp)
