"""Masked multi-head flash attention, forward: a hand-written CUDA kernel
(csrc/flash_attention.cu) and its plain PyTorch version.

Replaces the TPU kernel `flash_attention`
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:295,
body `_flash_kernel` :259). Its numerics differ from `layers.mha`: the
logits are scaled by 1/sqrt(Dh) after the q.k product, padded keys get
-1e30 (not -inf), and the probabilities stay f32 through the value product.
The output is in q.dtype.

The route is chosen by dtype (`ROUTES`). bf16 takes the tensor-core
kernel: q.k on `wgmma` (exact bf16 products, f32 sums), p.v on `wgmma` too
with p split into bf16 high and low parts, so p keeps f32 accuracy (to
about 2^-16); K/V tiles stream through a cp.async ring. At the
wav2vec2-base self-attention (B=128) its bound on an H100 is 46.7 us of
q/k/v/o traffic. f32 takes the CUDA-core kernel. Both pick their own tiles
(the TPU function's `block_q` / `block_k` were its VMEM tiling and are not
arguments here). A query row whose keys are all masked is undefined, as in
the TPU kernel (which averages its padded keys in): neither version is held
to a value there.

Like the JAX package, nothing under `models/` calls this: the encoders and
the cross-modal block use `layers.mha` / the post-LN stack. `flash_attention`
takes the plain version for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import profiling
from . import _build

Tensor = torch.Tensor

NEG_BIG = -1e30
LAUNCHES = profiling.launch_key("flash_attention")


def _heads(x: Tensor, num_heads: int) -> Tensor:
    """[B, S, D] -> [B, H, S, Dh] in f32."""
    B, S, D = x.shape
    return x.float().reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, kv_mask: Tensor, *,
                          num_heads: int) -> Tensor:
    """The kernel's arithmetic over all keys at once: f32 throughout, scale
    after the product, -1e30 on padded keys, o / max(l, 1e-30)."""
    B, Sq, D = q.shape
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D // num_heads))
    s = s.masked_fill(kv_mask.float()[:, None, None, :] == 0, NEG_BIG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p, vh) / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return o.transpose(1, 2).reshape(B, Sq, D).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIGNATURES = {"flash_attention_bf16": _ARGTYPES, "flash_attention_f32": _ARGTYPES}
# The route by dtype: bf16 on the tensor cores, f32 on the CUDA cores.
ROUTES = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("flash_attention", _SIGNATURES)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, kv_mask: Tensor, *,
                    num_heads: int) -> Tensor:
    """q: [B, Sq, D], k/v: [B, Skv, D], kv_mask: [B, Skv] (1 valid / 0
    pad) -> [B, Sq, D] in q.dtype. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, or raises on what it does not take:
    Dh = D / num_heads must be 8..128 and a multiple of 8."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} are not [B, S, D]")
    B, Sq, D = q.shape
    Skv = k.shape[1]
    if (tuple(k.shape) != (B, Skv, D) or tuple(v.shape) != (B, Skv, D)
            or tuple(kv_mask.shape) != (B, Skv)):
        raise ValueError(f"flash_attention: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, kv_mask {tuple(kv_mask.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if num_heads < 1 or D % num_heads != 0:
        raise ValueError(f"flash_attention: D={D} is not a multiple of "
                         f"num_heads={num_heads}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, num_heads=num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    Dh = D // num_heads
    if not (8 <= Dh <= 128 and Dh % 8 == 0):
        raise ValueError(f"flash_attention: the kernel takes a head width of "
                         f"8..128, a multiple of 8; got Dh={Dh}")
    if B * num_heads > 65535:
        raise ValueError(f"flash_attention: B * num_heads = {B * num_heads} "
                         "is over the kernel's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != q.dtype or q.dtype not in ROUTES
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention: the kernel takes contiguous bf16 or f32 q, "
                f"k, v of one dtype on {q.device}; {name} is {t.dtype} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if kv_mask.device != q.device:
        raise ValueError(f"flash_attention: kv_mask on {kv_mask.device}, "
                         f"q on {q.device}")
    mask = kv_mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    _build.launch("flash_attention", _SIGNATURES, ROUTES[q.dtype], q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                  B, Sq, Skv, num_heads, Dh)
    profiling.launched(LAUNCHES)
    return out
