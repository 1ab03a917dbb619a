"""Streaming masked attentive-statistics pooling: a hand-written CUDA kernel
(csrc/attentive_pooling.cu) and its plain PyTorch version.

Replaces the TPU kernel `attentive_stats_pooling_pallas`
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:208,
body `_pool_kernel` :161). It is the one-pass arithmetic of that kernel,
not the model's two-pass `ops/pooling.attentive_stats_pooling`: masked
frames get a score of -1e30 (not -inf) and are also multiplied out of the
weights, the normaliser is clamped at 1e-30, and the std is
sqrt(max(E[x^2] - mean^2, 0) + 1e-6). All arithmetic is f32; the output
[B, 2D] is in x.dtype.

Like the JAX package (ops/pooling.py:8-13), nothing under `models/` calls
this: the model pools through `ops/pooling.py`. `attentive_stats_pooling`
takes the plain version for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

NEG_BIG = -1e30
POOL_EPS = 1e-6
MAX_D = 1536  # the kernel's [32, D] f32 tile of x fits shared memory
_DTYPES = (torch.bfloat16, torch.float32)
_HIDDEN = (32, 64, 128, 256)


def attentive_stats_pooling_plain(params: dict, x: Tensor, mask: Tensor) -> Tensor:
    """The kernel's arithmetic over the whole sequence at once, in f32."""
    xf = x.float()
    mf = mask.float()
    h = torch.tanh(xf @ params["w1"]["kernel"].float() + params["w1"]["bias"].float())
    sc = (h @ params["w2"]["kernel"].float()).squeeze(-1) + params["w2"]["bias"].float()
    sc = sc.masked_fill(mf == 0, NEG_BIG)
    e = torch.exp(sc - sc.amax(-1, keepdim=True)) * mf
    l = e.sum(-1, keepdim=True).clamp(min=1e-30)
    mean = torch.einsum("bs,bsd->bd", e, xf) / l
    ex2 = torch.einsum("bs,bsd->bd", e, xf * xf) / l
    std = torch.sqrt((ex2 - mean * mean).clamp(min=0.0) + POOL_EPS)
    return torch.cat([mean, std], dim=-1).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIGNATURES = {"attentive_pooling_bf16": _ARGTYPES, "attentive_pooling_f32": _ARGTYPES}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("attentive_pooling", _SIGNATURES)


def attentive_stats_pooling(params: dict, x: Tensor, mask: Tensor) -> Tensor:
    """params: {"w1": {kernel [D, H], bias [H]}, "w2": {kernel [H, 1], bias
    [1]}}; x: [B, S, D]; mask: [B, S] (1 valid / 0 pad) -> [B, 2D] in
    x.dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel, or raises on what it does not take."""
    if x.dim() != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"attentive_stats_pooling: x {tuple(x.shape)} and "
                         f"mask {tuple(mask.shape)} are not [B, S, D] and [B, S]")
    B, S, D = x.shape
    w1, b1 = params["w1"]["kernel"], params["w1"]["bias"]
    w2, b2 = params["w2"]["kernel"], params["w2"]["bias"]
    H = w1.shape[-1]
    if (tuple(w1.shape) != (D, H) or tuple(b1.shape) != (H,)
            or tuple(w2.shape) != (H, 1) or tuple(b2.shape) != (1,)):
        raise ValueError(f"attentive_stats_pooling: parameters w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)} do not fit D={D}")
    if x.device.type == "cpu":
        return attentive_stats_pooling_plain(params, x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"attentive_stats_pooling: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"attentive_stats_pooling: the kernel takes a "
                         f"contiguous bf16 or f32 x; got {x.dtype} "
                         f"(contiguous={x.is_contiguous()})")
    if D % 4 != 0 or D > MAX_D or H not in _HIDDEN:
        raise ValueError(f"attentive_stats_pooling: the kernel takes D % 4 == 0, "
                         f"D <= {MAX_D} and H in {_HIDDEN}; got D={D}, H={H}")
    for t in (mask, w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"attentive_stats_pooling: a tensor on {t.device}, "
                             f"x on {x.device}")
    f32 = [t.to(torch.float32).contiguous() for t in (mask, w1, b1, w2, b2)]
    out = torch.empty((B, 2 * D), dtype=x.dtype, device=x.device)
    entry = ("attentive_pooling_bf16" if x.dtype == torch.bfloat16
             else "attentive_pooling_f32")
    _build.launch("attentive_pooling", _SIGNATURES, entry, x.device, x.data_ptr(),
                  *(t.data_ptr() for t in f32), out.data_ptr(), B, S, D, H)
    attentive_stats_pooling.launches += 1
    return out


attentive_stats_pooling.launches = 0
