"""Primitive layers as plain functions on tensors, over nested dicts of
parameters with the JAX package's keys and layouts.

  * ``linear``:     ``{"kernel": [in, out], "bias": [out]}``, y = x @ W + b;
                    an int8 slot ``{"kernel_q", "w_scale"[, "bias"]}`` goes
                    to ops/quant.linear_int8
  * ``layer_norm``: ``{"scale": [dim], "bias": [dim]}``
  * ``conv1d``:     ``{"kernel": [out, in/groups, K], "bias": [out]}`` over
                    a channels-first [B, C, T]
  * ``mha``:        separate q/k/v/out projections, each a ``linear``

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
models/layers.py. `dropout` draws its masks from an explicit
torch.Generator on the tensor's device; it is the identity in the eval
forward (deterministic) and at rate 0.

`Init` draws parameters with the JAX package's init distributions (the
values differ: torch and JAX generators give other numbers); on the meta
device it only makes shapes, which the weight bridge uses as its template.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import quant
from . import remat as remat_lib

Tensor = torch.Tensor


class Init:
    """Parameter factory over one torch.Generator, device and dtype."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

    def _empty(self, shape) -> Tensor:
        return torch.empty(tuple(shape), device=self.device, dtype=self.dtype)

    def normal(self, shape, std: float = 1.0) -> Tensor:
        t = self._empty(shape)
        return t if t.is_meta else t.normal_(0.0, std, generator=self.generator)

    def uniform(self, shape, bound: float) -> Tensor:
        t = self._empty(shape)
        return t if t.is_meta else t.uniform_(-bound, bound,
                                              generator=self.generator)

    def zeros(self, shape) -> Tensor:
        return torch.zeros(tuple(shape), device=self.device, dtype=self.dtype)

    def ones(self, shape) -> Tensor:
        return torch.ones(tuple(shape), device=self.device, dtype=self.dtype)


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def kaiming_bound(fan_in: int) -> float:
    """torch.nn.Linear's default weight bound (kaiming_uniform, a=sqrt(5))."""
    return math.sqrt(1.0 / fan_in) * math.sqrt(3.0)


def init_linear(init: Init, in_dim: int, out_dim: int, *, xavier: bool = False,
                stack: tuple = ()) -> dict:
    """torch.nn.Linear's default init, or xavier with a zero bias; the
    kernel is [in, out] and `stack` prepends layer dimensions."""
    shape = (*stack, in_dim, out_dim)
    if xavier:
        return {"kernel": init.uniform(shape, xavier_bound(in_dim, out_dim)),
                "bias": init.zeros((*stack, out_dim))}
    return {"kernel": init.uniform(shape, kaiming_bound(in_dim)),
            "bias": init.uniform((*stack, out_dim), 1.0 / math.sqrt(in_dim))}


def init_normal_linear(init: Init, in_dim: int, out_dim: int, std: float,
                       stack: tuple = ()) -> dict:
    """HF-style normal(0, std) kernel with zero bias."""
    return {"kernel": init.normal((*stack, in_dim, out_dim), std),
            "bias": init.zeros((*stack, out_dim))}


def init_layer_norm(init: Init, dim: int, stack: tuple = ()) -> dict:
    return {"scale": init.ones((*stack, dim)), "bias": init.zeros((*stack, dim))}


def linear(params: dict, x: Tensor) -> Tensor:
    if "kernel_q" in params:  # an int8-quantised slot (ops/quant.py)
        return quant.linear_int8(params, x)
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"]
    return y


def conv1d(p: dict, x: Tensor, stride: int, *, groups: int = 1,
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


def gelu(x: Tensor) -> Tensor:
    """Exact erf GELU in f32, the tanh approximation in bf16 (the JAX
    package's per-dtype contract)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def layer_norm(params: dict, x: Tensor, *, eps: float = 1e-5) -> Tensor:
    """Moments in f32 whatever the activation dtype; returns x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def dropout(generator: Optional[torch.Generator], x: Tensor, rate: float,
            deterministic: bool, shard: Optional[Tuple[int, int, int]] = None) -> Tensor:
    """Inverted dropout: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype. The mask is drawn with torch.rand from
    `generator`, which must live on x's device (F.dropout takes none).
    `shard` = (dim, lo, full) says x is the part [lo, lo + x.shape[dim]) of
    a tensor `full` wide along dim (a tensor-parallel rank's heads or
    columns): the whole tensor's mask is drawn and this part kept, so that
    each part gets its own draws and the generator stays in step across
    the ranks."""
    if deterministic or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout: the training forward needs a torch.Generator")
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        dim, lo, full = shard
        shape[dim] = full
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(dim, lo, x.shape[dim])
    return torch.where(mask, x / keep, 0.0)


def init_mha(init: Init, embed_dim: int) -> dict:
    """torch.nn.MultiheadAttention's init, its packed in_proj split into
    q/k/v linears (xavier over the packed [3E, E] matrix, zero biases)."""
    a = xavier_bound(embed_dim, 3 * embed_dim)
    qkv = {n: {"kernel": init.uniform((embed_dim, embed_dim), a),
               "bias": init.zeros((embed_dim,))} for n in ("q", "k", "v")}
    out = {"kernel": init.uniform((embed_dim, embed_dim),
                                  kaiming_bound(embed_dim)),
           "bias": init.zeros((embed_dim,))}
    return {**qkv, "out": out}


def mha(params: dict, q: Tensor, k: Tensor, v: Tensor, *, num_heads: int,
        key_padding_mask: Optional[Tensor] = None, dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True, tp=None) -> Tensor:
    """Multi-head attention with torch.nn.MultiheadAttention's semantics.

    q: [B, Sq, E], k/v: [B, Sk, E]; key_padding_mask: [B, Sk] with 1 for
    VALID (the inverse of torch's convention). The logits are divided by
    sqrt(Dh) after the product, masked with -inf, and the softmax runs in
    f32; its weights are cast back to q.dtype, and dropped out in training,
    before the value product. Under `tp` (a parallel/tensor.ModelGroup;
    q/k/v/out kernels this rank's shards) this rank computes its heads and
    the row-parallel `out` sums the group's.
    """
    B, Sq, E = q.shape
    Sk = k.shape[1]
    H = num_heads
    D = E // H
    lo, hi = (0, H) if tp is None else tp.span(H, "attention heads")
    proj = params
    if tp is not None:
        from ..parallel import tensor as tpl
        q, k, v = (tpl.copy_to_model(x, tp) for x in (q, k, v))
        proj = {n: {**params[n], "bias": tpl.local_part(params[n]["bias"], -1,
                                                        (lo * D, hi * D), tp)}
                for n in ("q", "k", "v")}
    qh = linear(proj["q"], q).reshape(B, Sq, hi - lo, D)
    kh = linear(proj["k"], k).reshape(B, Sk, hi - lo, D)
    vh = linear(proj["v"], v).reshape(B, Sk, hi - lo, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float()
    logits = logits / math.sqrt(D)
    if key_padding_mask is not None:
        pad = (key_padding_mask == 0)[:, None, None, :]
        logits = logits.masked_fill(pad, -math.inf)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    attn = dropout(generator, attn, dropout_rate, deterministic,
                   shard=None if tp is None else (1, lo, H))
    ctx = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Sq, (hi - lo) * D)
    if tp is None:
        return linear(params["out"], ctx)
    return tpl.row_linear(params["out"], ctx, tp)


def layer_at(stacked, i: int):
    """Layer i of stacked [L, ...] parameters (nested dicts of tensors)."""
    if isinstance(stacked, dict):
        return {k: layer_at(v, i) for k, v in stacked.items()}
    return stacked[i]


def key_mask_bias(mask: Tensor) -> Tensor:
    """Additive f32 attention bias [B, 1, 1, S]: -inf on padded keys."""
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    return bias.masked_fill(mask == 0, -math.inf)[:, None, None, :]


def encoder_stack(stacked: dict, h: Tensor, attn_bias: Tensor, *,
                  num_heads: int, eps: float, pre_ln: bool = False,
                  logit_bias: Optional[Callable[[dict, Tensor], Tensor]] = None,
                  attention_dropout: float = 0.0, hidden_dropout: float = 0.0,
                  activation_dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True,
                  remat: remat_lib.RematSpec = False, tp=None) -> Tensor:
    """Transformer layers over stacked [L, ...] parameters, shared by
    wav2vec2 and XLM-R. Post-LN blocks by default, LN(x + attn(x)) then
    LN(x + ffn(x)); `pre_ln` gives the stable-LN blocks, x + attn(LN(x))
    then x + ffn(LN(x)). q is scaled by 1/sqrt(Dh) before the product; the
    logits are f32, plus attn_bias, plus logit_bias(layer, attention input)
    where given (WavLM's gated relative position bias, over this rank's
    heads under `tp`); the softmax runs in f32 and is cast back to h.dtype.
    In training the dropout sites are the JAX package's: attention weights
    (attention_dropout), the attention output and the FFN output
    (hidden_dropout), the FFN's GELU output (activation_dropout; XLM-R has
    none). `remat` checkpoints each layer (models/remat.py).

    Under `tp` (a parallel/tensor.ModelGroup) the q/k/v/out/ffn_in/ffn_out
    kernels are this rank's shards: q, k, v and ffn_in column-parallel (the
    rank's heads and FFN columns, their bias cut here once for the stack),
    out and ffn_out row-parallel (summed over the group, the bias added
    after), LN and residuals replicated. The attention weights' and the
    GELU output's dropout draws are this rank's part of the whole tensor's;
    the hidden dropout after each sum draws the same mask on every rank."""
    B, S, E = h.shape
    H = num_heads
    D = E // H
    scale = D ** -0.5
    lo, hi = 0, H
    if tp is not None:
        from ..parallel import tensor as tpl
        lo, hi = tp.span(H, "attention heads")
        F = stacked["ffn_in"]["bias"].shape[-1]
        f_span = tp.span(F, "FFN columns")
        stacked = {**stacked, **{n: {**stacked[n], "bias": tpl.local_part(
            stacked[n]["bias"], -1, (lo * D, hi * D), tp)} for n in ("q", "k", "v")},
                   "ffn_in": {**stacked["ffn_in"], "bias": tpl.local_part(
                       stacked["ffn_in"]["bias"], -1, f_span, tp)}}
    Hl = hi - lo

    def row(p: dict, x: Tensor) -> Tensor:
        return linear(p, x) if tp is None else tpl.row_linear(p, x, tp)

    def attention(x: Tensor, layer: dict, g: Optional[torch.Generator]) -> Tensor:
        if tp is not None:
            x = tpl.copy_to_model(x, tp)
        q = (linear(layer["q"], x) * scale).reshape(B, S, Hl, D)
        k = linear(layer["k"], x).reshape(B, S, Hl, D)
        v = linear(layer["v"], x).reshape(B, S, Hl, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + attn_bias
        if logit_bias is not None:
            logits = logits + logit_bias(layer, x)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = dropout(g, attn, attention_dropout, deterministic,
                       shard=None if tp is None else (1, lo, H))
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, Hl * D)
        return dropout(g, row(layer["out"], ctx), hidden_dropout, deterministic)

    def ffn(x: Tensor, layer: dict, g: Optional[torch.Generator]) -> Tensor:
        if tp is not None:
            x = tpl.copy_to_model(x, tp)
        f = gelu(linear(layer["ffn_in"], x))
        f = dropout(g, f, activation_dropout, deterministic,
                    shard=None if tp is None else (2, f_span[0], F))
        return dropout(g, row(layer["ffn_out"], f), hidden_dropout, deterministic)

    def body(h: Tensor, layer: dict, g: Optional[torch.Generator]) -> Tensor:
        if pre_ln:
            h = h + attention(layer_norm(layer["attn_ln"], h, eps=eps), layer, g)
            return h + ffn(layer_norm(layer["final_ln"], h, eps=eps), layer, g)
        h = layer_norm(layer["attn_ln"], h + attention(h, layer, g), eps=eps)
        return layer_norm(layer["final_ln"], h + ffn(h, layer, g), eps=eps)

    run = remat_lib.apply_remat(body, remat)
    for i in range(stacked["attn_ln"]["scale"].shape[0]):  # int8 leaves no "kernel"
        h = run(h, layer_at(stacked, i), generator)
    return h
