"""The wav2vec2 conv-extractor tail (conv layers 1-6): a hand-written CUDA
kernel (csrc/conv_tail.cu) and its plain PyTorch version.

Replaces the TPU kernel `conv_tail_pallas`
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:467,
body `_conv_tail_kernel` :423). Layers 1-6 of the HF wav2vec2 / HuBERT /
WavLM feature encoder have kernels (3, 3, 3, 3, 2, 2), stride 2 and C
channels in and out. Per layer, in the working type of x1 (bf16 or f32):
the product in f32 from operands rounded to the working type, rounded
once; + bias; optionally a per-frame LayerNorm over C with f32 moments;
GELU (`layers.gelu`: tanh approximation in bf16, erf in f32).

The two k=3 products of the TPU kernel are summed in f32 before their one
cast (pallas_kernels.py:432-438), so each layer rounds once, as a
convolution does; the comment at pallas_kernels.py:384-387 that says the
k=3 layers round twice does not describe that code. This module follows
the code.

Layout: [B, T, C] in and out, like the JAX function. The kernel reads each
layer as one GEMM over the overlapping-row view of its input (see the
source), one launch per layer. The route is chosen by dtype (`ROUTES`):
bf16 takes a persistent wgmma GEMM fed by TMA through an mbarrier ring
(one tensor map per tap over the overlapping rows, the weights packed
K-major), f32 a CUDA-core GEMM. At wav2vec2-base width, 4 s clips and
B=128 the bound on an H100 is the products: 2.495 TFLOP, 2.52 ms at the
bf16 tensor cores' 989 TFLOP/s.

The tail is the registered op `ser_torch::conv_tail` (its CPU
implementation the plain version, its CUDA implementation the launch), so
a program traced by torch.export holds one node for it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..models import layers
from ..utils import profiling
from . import _build

Tensor = torch.Tensor

TAIL_KERNELS = (3, 3, 3, 3, 2, 2)
LAUNCHES = profiling.launch_key("conv_tail")


def conv_tail_supported(conv_kernel: Sequence[int], conv_stride: Sequence[int],
                        conv_dim: Sequence[int]) -> bool:
    """True when the conv stack's tail has the fused geometry: kernels
    (K0, 3, 3, 3, 3, 2, 2), strides (S0, 2, ..., 2) and one channel count,
    a multiple of 128 (the HF wav2vec2 / HuBERT / WavLM base and large
    extractors). The port's copy of the JAX package's
    `conv_tail_supported` (pallas_kernels.py:457)."""
    return (tuple(conv_kernel[1:]) == TAIL_KERNELS
            and all(s == 2 for s in conv_stride[1:])
            and len(set(conv_dim)) == 1
            and conv_dim[0] % 128 == 0)


def takes(convs: list, conv_stride: Sequence[int], device: torch.device,
          dtype: torch.dtype) -> bool:
    """Whether `conv_tail` launches the kernel for an x1 on `device` in
    `dtype`: CUDA, a dtype of ROUTES, the stack's geometry
    (`conv_tail_supported`), no gradient wanted for its parameters."""
    tensors = _layer_tensors(convs)
    return (device.type == "cuda" and dtype in ROUTES
            and conv_tail_supported([k.shape[-1] for k in tensors[0]], conv_stride,
                                    [k.shape[0] for k in tensors[0]])
            and not _build.grad_wanted(t for group in tensors for t in group))


def tail_lengths(T1: int) -> List[int]:
    """Frames after each of the six layers: exact conv arithmetic."""
    out = []
    for k in TAIL_KERNELS:
        T1 = (T1 - k) // 2 + 1
        out.append(T1)
    return out


def _packed_kernels(convs: list, dtype: torch.dtype, *,
                    k_major: bool = False) -> List[Tensor]:
    """Each tail layer's kernel, stored [C_out, C_in, K], as the [K*C_in,
    C_out] matrix whose row k*C_in + c multiplies x[2t + k, c]; with
    `k_major`, as its transpose [C_out, K*C_in] (the layout that the bf16
    kernel's TMA loads and wgmma's B operand take)."""
    if k_major:
        return [c["kernel"].to(dtype).permute(0, 2, 1).reshape(c["kernel"].shape[0], -1)
                for c in convs[1:]]
    return [c["kernel"].to(dtype).permute(2, 1, 0).reshape(-1, c["kernel"].shape[0])
            for c in convs[1:]]


def _check_convs(convs: list, C: int, has_ln: bool) -> None:
    if len(convs) != 7:
        raise ValueError(f"conv_tail: convs has {len(convs)} layers; the "
                         "tail needs the extractor's 7 (layers 1-6 are fused)")
    for i, (conv, k) in enumerate(zip(convs[1:], TAIL_KERNELS), start=1):
        if tuple(conv["kernel"].shape) != (C, C, k):
            raise ValueError(f"conv_tail: convs[{i}] kernel "
                             f"{tuple(conv['kernel'].shape)} is not [{C}, {C}, {k}]")
        if has_ln and "ln" not in conv:
            raise ValueError(f"conv_tail: has_ln=True but convs[{i}] has no 'ln'")


def conv_tail_plain(convs: list, x1: Tensor, *, has_ln: bool,
                    ln_eps: float = 1e-5) -> Tensor:
    """Layers 1-6 over x1 [B, T1, C] -> [B, T7, C], as the kernel computes
    them: each product in f32 from operands in x1.dtype, rounded once."""
    B, _, C = x1.shape
    _check_convs(convs, C, has_ln)
    x = x1
    for conv, k, w in zip(convs[1:], TAIL_KERNELS, _packed_kernels(convs, x1.dtype)):
        x = x.contiguous()
        T = x.shape[1]
        T_out = (T - k) // 2 + 1
        window = x.as_strided((B, T_out, k * C), (T * C, 2 * C, 1))
        z = torch.matmul(window.float(), w.float()).to(x1.dtype)
        if "bias" in conv:
            z = z + conv["bias"].to(x1.dtype)
        if has_ln:
            z = layers.layer_norm(conv["ln"], z, eps=ln_eps)
        x = layers.gelu(z)
    return x


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {"conv_tail_bf16": _ARGTYPES, "conv_tail_f32": _ARGTYPES}
# The route by dtype: (entry point, weights packed K-major). bf16 takes the
# TMA + wgmma GEMM, f32 the CUDA-core one.
ROUTES = {torch.bfloat16: ("conv_tail_bf16", True),
          torch.float32: ("conv_tail_f32", False)}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("conv_tail", _SIGNATURES)


def _layer_tensors(convs: list) -> tuple:
    """The op's per-layer tensors: kernels, and biases, LN scales and LN
    shifts or None where a layer has none."""
    norms = [c.get("ln", {}) for c in convs]
    return ([c["kernel"] for c in convs], [c.get("bias") for c in convs],
            [n.get("scale") for n in norms], [n.get("bias") for n in norms])


def _convs(kernels, biases, ln_scales, ln_shifts) -> list:
    """params["convs"] again from `_layer_tensors`."""
    convs = []
    for kernel, bias, scale, shift in zip(kernels, biases, ln_scales, ln_shifts):
        conv = {"kernel": kernel}
        if bias is not None:
            conv["bias"] = bias
        if scale is not None:
            conv["ln"] = {"scale": scale, "bias": shift}
        convs.append(conv)
    return convs


@torch.library.custom_op("ser_torch::conv_tail", mutates_args=(), device_types="cpu")
def conv_tail_op(x1: Tensor, kernels: List[Tensor], biases: List[Optional[Tensor]],
                 ln_scales: List[Optional[Tensor]], ln_shifts: List[Optional[Tensor]],
                 has_ln: bool, ln_eps: float) -> Tensor:
    """The tail as a registered op, so that the dispatcher, and with it
    torch.export, sees one node where the kernel launches. On the CPU it
    is the plain version; on CUDA the kernel (`_conv_tail_cuda`)."""
    return conv_tail_plain(_convs(kernels, biases, ln_scales, ln_shifts), x1,
                           has_ln=has_ln, ln_eps=ln_eps)


@conv_tail_op.register_fake
def _conv_tail_fake(x1, kernels, biases, ln_scales, ln_shifts, has_ln, ln_eps):
    B, T1, C = x1.shape
    return x1.new_empty((B, tail_lengths(T1)[-1], C))


@conv_tail_op.register_kernel("cuda")
def _conv_tail_cuda(x1: Tensor, kernels: List[Tensor], biases: List[Optional[Tensor]],
                    ln_scales: List[Optional[Tensor]], ln_shifts: List[Optional[Tensor]],
                    has_ln: bool, ln_eps: float) -> Tensor:
    """The launch: checks what the kernel takes, packs the weights, counts it."""
    convs = _convs(kernels, biases, ln_scales, ln_shifts)
    B, T1, C = x1.shape
    lengths = tail_lengths(T1)
    _check_convs(convs, C, has_ln)
    if (x1.dtype not in ROUTES or not x1.is_contiguous()
            or x1.data_ptr() % 16 != 0):
        raise ValueError(f"conv_tail: the kernel takes a contiguous, 16-byte "
                         f"aligned bf16 or f32 x1; got {x1.dtype} "
                         f"(contiguous={x1.is_contiguous()})")
    if C % 128 != 0 or not 1 <= B <= 65535:
        raise ValueError(f"conv_tail: the kernel takes C % 128 == 0 and "
                         f"1 <= B <= 65535, got C={C}, B={B}")
    for conv in convs[1:]:
        for t in (conv["kernel"], conv.get("bias"),
                  *(conv["ln"].values() if has_ln else ())):
            if t is not None and t.device != x1.device:
                raise ValueError(f"conv_tail: parameters on {t.device}, "
                                 f"x1 on {x1.device}")
    dtype = x1.dtype
    entry, k_major = ROUTES[dtype]
    w = torch.cat([p.reshape(-1) for p in _packed_kernels(convs, dtype, k_major=k_major)])
    bias = torch.stack([c["bias"].to(dtype) if "bias" in c
                        else torch.zeros(C, dtype=dtype, device=x1.device)
                        for c in convs[1:]])
    if has_ln:
        ln_s = torch.stack([c["ln"]["scale"].float() for c in convs[1:]])
        ln_b = torch.stack([c["ln"]["bias"].float() for c in convs[1:]])
    else:
        ln_s = ln_b = torch.zeros((6, C), dtype=torch.float32, device=x1.device)
    scratch = torch.empty(B * (lengths[0] + lengths[1]) * C, dtype=dtype,
                          device=x1.device)
    out = torch.empty((B, lengths[-1], C), dtype=dtype, device=x1.device)
    _build.launch("conv_tail", _SIGNATURES, entry, x1.device, x1.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), B, T1, C, int(has_ln), ln_eps)
    profiling.launched(LAUNCHES)
    return out


def conv_tail(convs: list, x1: Tensor, *, has_ln: bool,
              ln_eps: float = 1e-5) -> Tensor:
    """Conv layers 1-6 over the layer-0 output x1 [B, T1, C] -> [B, T7, C].
    convs: params["convs"] (7 layers, kernels [C_out, C_in, K], optional
    "bias" and "ln"). It calls `ser_torch::conv_tail`: on a CPU tensor the
    plain version, on a CUDA tensor the kernel (which packs the weights
    itself), which raises on what it does not take; a call that wants a
    gradient goes by `_build.takes_plain`."""
    if x1.dim() != 3:
        raise ValueError(f"conv_tail: x1 {tuple(x1.shape)} is not [B, T1, C]")
    if tail_lengths(x1.shape[1])[-1] < 1:
        raise ValueError(f"conv_tail: T1={x1.shape[1]} frames are too few for the "
                         "six stride-2 layers")
    tensors = _layer_tensors(convs)
    if _build.takes_plain("conv_tail", x1.device, (x1, *(t for group in tensors for t in group))):
        return conv_tail_plain(convs, x1, has_ln=has_ln, ln_eps=ln_eps)
    return torch.ops.ser_torch.conv_tail(x1, *tensors, has_ln, ln_eps)

