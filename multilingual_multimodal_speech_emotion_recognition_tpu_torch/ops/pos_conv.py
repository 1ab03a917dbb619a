"""wav2vec2's grouped positional conv with its bias and GELU (F2): a
hand-written CUDA kernel (csrc/pos_conv.cu) and its plain PyTorch version.

It replaces no TPU kernel: the JAX package runs the conv as lax.conv. The
port's plain version is the chain `models/wav2vec2._positional_conv` ran
before the kernel: a grouped conv1d (G groups of Cg channels, K taps,
padding K // 2) over a channels-first view of h [B, T, C], the bias added
in h's dtype, the even kernel's extra frame cut, and GELU (`layers.gelu`).
On the card that conv is cuDNN's non-tensor-core fallback, about 150x its
bound at wav2vec2-base's shape. The kernel reads h and writes pos [B, T, C]
channels-last, with the chain's rounding points (the product in f32 from
bf16 operands rounded once, the bias add rounded, the tanh GELU rounded);
only the order of the f32 sums differs. Bound on an H100: the products,
9.44 MFLOP a frame at wav2vec2-base's width, 0.49 ms for a benchmark batch
of 51k frames at the bf16 tensor cores' 989 TFLOP/s.

The op is registered as `ser_torch::pos_conv` (its CPU implementation the
plain version, its CUDA implementation the launch), so a program traced by
torch.export holds one node for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models import layers
from ..utils import profiling
from . import _build

Tensor = torch.Tensor

GROUP_CHANNELS = (48, 64)   # Cg: the wgmma widths the kernel has
MAX_TAPS = 128              # a tile's halo, 127 + K rows, fits one 256-row TMA box
LAUNCHES = profiling.launch_key("pos_conv")


def pos_conv_supported(group_channels: int, taps: int) -> bool:
    """True where the kernel takes the conv's shape: Cg in GROUP_CHANNELS
    and an even K of at most MAX_TAPS (wav2vec2-base, -large, HuBERT and
    WavLM: K = 128; not the tiny students' Cg = 16)."""
    return group_channels in GROUP_CHANNELS and taps % 2 == 0 and 2 <= taps <= MAX_TAPS


def takes(conv: dict, h: Tensor) -> bool:
    """Whether `pos_conv` launches the kernel: CUDA bf16, its Cg and K, no gradient."""
    kernel = conv["kernel"]
    return (h.is_cuda and h.dtype == torch.bfloat16
            and pos_conv_supported(kernel.shape[1], kernel.shape[-1])
            and not _build.grad_wanted((h, *conv.values())))


def pos_conv_plain(conv: dict, h: Tensor) -> Tensor:
    """GELU of the grouped conv of h [B, T, C] with conv["kernel"] [C_out,
    Cg, K] (groups C / Cg, padding K // 2) and conv["bias"]: [B, T, C_out],
    a transposed view of the channels-first result."""
    kernel = conv["kernel"]
    K = kernel.shape[-1]
    pos = layers.conv1d(conv, h.transpose(1, 2), 1, groups=h.shape[-1] // kernel.shape[1],
                        padding=K // 2)
    # an even kernel with padding k//2 gives T+1 frames: keep the first T
    return layers.gelu(pos[:, :, : h.shape[1]].transpose(1, 2))


def _conv(kernel: Tensor, bias: Optional[Tensor]) -> dict:
    return {"kernel": kernel} if bias is None else {"kernel": kernel, "bias": bias}


@torch.library.custom_op("ser_torch::pos_conv", mutates_args=(), device_types="cpu")
def pos_conv_op(h: Tensor, kernel: Tensor, bias: Optional[Tensor]) -> Tensor:
    """The conv as a registered op, so that the dispatcher, and with it
    torch.export, sees one node where the kernel launches. On the CPU it
    is the plain version; on CUDA the kernel (`_pos_conv_cuda`)."""
    return pos_conv_plain(_conv(kernel, bias), h).contiguous()


@pos_conv_op.register_fake
def _pos_conv_fake(h, kernel, bias):
    return h.new_empty(h.shape)


_SIGNATURES = {"pos_conv_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
               + [ctypes.c_void_p]}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("pos_conv", _SIGNATURES)


@pos_conv_op.register_kernel("cuda")
def _pos_conv_cuda(h: Tensor, kernel: Tensor, bias: Optional[Tensor]) -> Tensor:
    """The launch: checks what the kernel takes, packs the weights, counts it."""
    if (h.dim() != 3 or h.dtype != torch.bfloat16 or not h.is_contiguous()
            or h.data_ptr() % 16 != 0):
        raise ValueError(f"pos_conv: the kernel takes a contiguous, 16-byte aligned bf16 "
                         f"h [B, T, C]; got {tuple(h.shape)} {h.dtype} "
                         f"(contiguous={h.is_contiguous()})")
    B, T, C = h.shape
    Cg, K = (kernel.shape[1], kernel.shape[-1]) if kernel.dim() == 3 else (0, 0)
    if kernel.shape[0] != C or C % max(Cg, 1) != 0 or not pos_conv_supported(Cg, K):
        raise ValueError(f"pos_conv: the kernel takes a kernel [C, Cg, K] with Cg in "
                         f"{GROUP_CHANNELS} and an even K <= {MAX_TAPS}; got "
                         f"{tuple(kernel.shape)} for C={C}")
    if B < 1 or T < 1:
        raise ValueError(f"pos_conv: the kernel takes B, T >= 1, got B={B}, T={T}")
    for t in (kernel, bias):
        if t is not None and t.device != h.device:
            raise ValueError(f"pos_conv: a parameter on {t.device}, h on {h.device}")
    if bias is not None and tuple(bias.shape) != (C,):
        raise ValueError(f"pos_conv: bias {tuple(bias.shape)} is not [{C}]")
    w = kernel.to(torch.bfloat16).permute(0, 2, 1).reshape(C, K * Cg).contiguous()
    b = (torch.zeros(C, dtype=torch.bfloat16, device=h.device) if bias is None
         else bias.to(torch.bfloat16).contiguous())
    out = torch.empty_like(h)
    _build.launch("pos_conv", _SIGNATURES, "pos_conv_bf16", h.device, h.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), B, T, C // Cg, Cg, K)
    profiling.launched(LAUNCHES)
    return out


def pos_conv(conv: dict, h: Tensor) -> Tensor:
    """GELU(grouped conv(h) + bias) of h [B, T, C] -> [B, T, C], contiguous:
    conv is params["pos_conv"] (kernel [C, Cg, K], optional bias), groups
    C / Cg, padding K // 2, the first T frames. It calls
    `ser_torch::pos_conv`: on a CPU tensor the plain version, on a CUDA
    tensor the kernel, which takes bf16 and raises on what it does not
    take; a call that wants a gradient goes by `_build.takes_plain`."""
    if _build.takes_plain("pos_conv", h.device, (h, *conv.values())):
        return pos_conv_plain(conv, h)
    return torch.ops.ser_torch.pos_conv(h, conv["kernel"], conv.get("bias"))

