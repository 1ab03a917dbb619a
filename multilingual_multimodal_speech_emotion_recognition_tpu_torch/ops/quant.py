"""Int8 weight quantisation for the serving path.

Counterpart of multilingual_multimodal_speech_emotion_recognition_tpu/
ops/quant.py, with the same scheme and tree layout:

  * weights: symmetric per-output-channel int8 (scale = max|W| / 127 over
    the input dim), computed once by `quantize_backbones` /
    `quantize_whisper`;
  * activations: dynamic symmetric per-row int8 (scale over the feature
    dim), computed on the fly in `linear_int8`;
  * an exact int32 product, dequantised by a_scale x w_scale in f32, bias
    added, cast back to the activation dtype.

A quantised linear keeps its slot in the tree with the keys {kernel_q
[..., I, O] int8, w_scale [..., O] f32[, bias]}; `models/layers.linear`
dispatches on `kernel_q`. `cast_floating` (models/model.py) leaves
`w_scale` in f32.

On the card the int8 product is `torch._int_mm` (cuBLASLt), which wants
more than 16 rows (fewer are padded with zero rows, which quantise to
zeros) and the weight column-major: cuBLASLt has no int8 route for a
row-major [I, O] operand inside an exported program, and takes a slower
one eagerly. So `quantize_linear` stores `kernel_q` as the [..., I, O]
view of a contiguous [..., O, I] tensor (`card_layout`): the shape and
values are the JAX package's, the memory is the transposed matrix. On the
CPU the product is `int8_matmul_plain`, an int32 matmul.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from ..utils import profiling

Tensor = torch.Tensor

_EPS = 1e-12
MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
LAUNCHES = profiling.launch_key("int8_matmul")


def _per_127(t: Tensor) -> Tensor:
    """t / 127 as an IEEE division on every device, as JAX divides: CUDA
    turns a division by a Python number into a product with its
    reciprocal, one ulp off at some values, which moves an int8 level."""
    return t / torch.full_like(t, 127.0)


def card_layout(q: Tensor) -> Tensor:
    """q [..., I, O] with each matrix stored column-major (as the contiguous
    [..., O, I] transpose), the layout `torch._int_mm` takes on the card."""
    return q.mT.contiguous().mT


def quantize_linear(p: dict) -> dict:
    """{kernel[, bias]} -> {kernel_q, w_scale[, bias]}; kernel [..., I, O]."""
    w = p["kernel"].float()
    s = torch.clamp(_per_127(w.abs().amax(-2)), min=_EPS)  # [..., O]
    q = torch.clamp(torch.round(w / s[..., None, :]), -127, 127).to(torch.int8)
    out = {"kernel_q": card_layout(q), "w_scale": s}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def int8_matmul_plain(xq: Tensor, kq: Tensor) -> Tensor:
    """[M, I] int8 x [I, O] int8 -> [M, O] int32, exact (int32 matmul)."""
    return torch.matmul(xq.to(torch.int32), kq.to(torch.int32))


def _int_mm_padded(xq: Tensor, kq: Tensor) -> Tensor:
    """torch._int_mm with the rows padded to MIN_ROWS with zeros and the
    result sliced back; the same int32 product."""
    M = xq.shape[0]
    if M < MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, MIN_ROWS - M))
    return torch._int_mm(xq.contiguous(), kq)[:M]


def int8_matmul(xq: Tensor, kq: Tensor) -> Tensor:
    """[M, I] int8 x [I, O] int8 -> [M, O] int32. A CPU tensor takes the
    plain int32 matmul; a CUDA tensor takes torch._int_mm (counted in
    `int8_matmul.launches`) or raises where cuBLASLt cannot take it."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, kq)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul: no route for device {xq.device}")
    I, O = kq.shape
    if I % 8 or O % 8:
        raise ValueError(f"int8_matmul: torch._int_mm needs both weight dims a "
                         f"multiple of 8, got [{I}, {O}]")
    if kq.stride(0) != 1:
        raise ValueError("int8_matmul: kernel_q must be column-major on the card "
                         "(quant.card_layout, as quantize_linear stores it)")
    profiling.launched(LAUNCHES)
    return _int_mm_padded(xq, kq)


def linear_int8(params: dict, x: Tensor) -> Tensor:
    """Dynamic-activation int8 matmul: y = (x_q . W_q) * s_a * s_w + b."""
    out_dtype = x.dtype
    xf = x.float()
    a_scale = torch.clamp(_per_127(xf.abs().amax(-1, keepdim=True)), min=_EPS)
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    kq = params["kernel_q"]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kq).reshape(*x.shape[:-1], kq.shape[-1])
    y = acc.float() * a_scale * params["w_scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(out_dtype)


# slots with a "kernel" that is not a product's: w2v-BERT's depthwise taps
# [L, K, C] (models/w2v_bert.py)
NOT_PRODUCTS = ("depthwise",)


def _walk(node, min_size: int):
    if isinstance(node, dict):
        k = node.get("kernel")
        if k is not None and k.ndim >= 2 and min(k.shape[-2:]) >= min_size:
            return quantize_linear(node)
        return {key: (v if key in NOT_PRODUCTS else _walk(v, min_size))
                for key, v in node.items()}
    return node


def quantize_whisper(params: dict, *, min_size: int = 512) -> dict:
    """Int8 the Whisper encoder and decoder layer stacks (attention q/k/v/
    out, cross-attention, FFN: the stacked [L, I, O] kernels). The mel
    convs, layer norms, positional tables and the tied token embedding stay
    float: only the "layers" stacks are walked, and the logits read the
    embedding table directly. Greedy decode re-reads the decoder's weights
    for every token, so halving their bytes is what this is for."""
    out = dict(params)
    for key in ("encoder", "decoder"):
        if key in out and "layers" in out[key]:
            sub = dict(out[key])
            sub["layers"] = _walk(sub["layers"], min_size)
            out[key] = sub
    return out


def quantize_backbones(params: dict, *,
                       subtrees: Iterable[str] = ("audio_backbone", "text_backbone"),
                       min_size: int = 512) -> dict:
    """Quantise the encoder layers' matmuls (q/k/v/out/ffn, and w2v-BERT's
    FFNs and pointwise convs) of both backbones in a model tree; the conv
    extractor, w2v-BERT's depthwise taps and distance embedding, norms,
    adapters, heads and the classifier stay float. `min_size` leaves small
    matrices (WavLM's gate, [L, 64, 8]) float."""
    out = dict(params)
    for key in subtrees:
        if key in out:
            sub = dict(out[key])
            if "layers" in sub:
                sub["layers"] = _walk(sub["layers"], min_size)
            out[key] = sub
    return out
