"""The wav2vec2 conv-extractor front in group mode (conv 0, its masked group
norm and GELU): a hand-written CUDA kernel (csrc/conv_front.cu) and its
plain PyTorch version.

It replaces no TPU kernel: the JAX package computes conv 0 and its norm with
lax.conv and jnp. The port's plain version does the same with cuDNN and a
dozen f32 elementwise passes and reductions over the [B, C, T1] conv-0
output, then transposes it for the tail; at 1024 audio-seconds those
passes move 7-13 GB each. The kernel reads the bf16 waveform and writes
the bf16 output [B, T1, C] once, channels-last, the layout that the tail
(ops/conv_tail.conv_tail, layers 1-6) takes as it is. Bound on an H100:
the output's bytes, 3.36 GB at 1024 audio-seconds, 1.0 ms at 3.35 TB/s.

Rounding points are the plain version's: the conv-0 product in f32 from
bf16 operands, rounded once; the group norm's moments in f32 over each
clip's valid frames, (len - 10) // 5 + 1 of them, counted as at least 1;
the normalised value rounded to bf16; the tanh GELU in f32 from it,
rounded. Only the order of the f32 sums differs.

The front is the registered op `ser_torch::conv_front` (its CPU
implementation the plain version, its CUDA implementation the launch), so
a program traced by torch.export holds one node for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..models import layers
from ..utils import profiling
from . import _build

Tensor = torch.Tensor

KERNEL, STRIDE = 10, 5     # conv 0 of the HF wav2vec2 / HuBERT / WavLM extractors
MAX_CHANNELS = 4096        # C / 4 threads a block of the apply pass
LAUNCHES = profiling.launch_key("conv_front")


def conv_front_supported(conv_kernel: Sequence[int], conv_stride: Sequence[int],
                         conv_dim: Sequence[int]) -> bool:
    """True when conv 0 has the kernel's geometry: kernel 10, stride 5 and
    a multiple of 128 channels, at most MAX_CHANNELS."""
    return (conv_kernel[0] == KERNEL and conv_stride[0] == STRIDE
            and conv_dim[0] % 128 == 0 and conv_dim[0] <= MAX_CHANNELS)


def takes(conv0: dict, group_norm: dict, wave: Tensor, stride: int) -> bool:
    """Whether `conv_front` launches the kernel: CUDA bf16, conv 0's geometry, no gradient."""
    kernel = conv0["kernel"]
    return (wave.is_cuda and wave.dtype == torch.bfloat16
            and conv_front_supported(kernel.shape[-1:], (stride,), kernel.shape[:1])
            and not _build.grad_wanted((wave, *conv0.values(), *group_norm.values())))


def masked_group_norm_per_channel(p: dict, x: Tensor, frame_mask: Tensor,
                                  eps: float = 1e-5) -> Tensor:
    """GroupNorm(C, C) with statistics over valid frames only.
    x: [B, C, T] (channels-first), frame_mask: [B, T]."""
    xf = x.float()
    m = frame_mask.float()[:, None, :]
    n = m.sum(-1, keepdim=True).clamp(min=1.0)
    mean = (xf * m).sum(-1, keepdim=True) / n
    var = ((xf - mean).square() * m).sum(-1, keepdim=True) / n
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()[:, None] + p["bias"].float()[:, None]
    return y.to(x.dtype)


def conv_front_plain(conv0: dict, group_norm: dict, wave: Tensor, samples: Tensor,
                     stride: int, eps: float = 1e-5) -> Tensor:
    """Conv 0 of wave [B, T], its masked group norm over each clip's
    `samples` [B] valid samples, and GELU: [B, T1, C], a transposed view
    of the channels-first result (the extractor's unfused path)."""
    x = layers.conv1d(conv0, wave[:, None, :], stride)
    frames = (samples - conv0["kernel"].shape[-1]) // stride + 1
    fm = torch.arange(x.shape[-1], device=x.device)[None, :] < frames[:, None]
    return layers.gelu(masked_group_norm_per_channel(group_norm, x, fm, eps)).transpose(1, 2)


def _params(kernel, bias, scale, shift) -> tuple:
    conv0 = {"kernel": kernel} if bias is None else {"kernel": kernel, "bias": bias}
    return conv0, {"scale": scale, "bias": shift}


@torch.library.custom_op("ser_torch::conv_front", mutates_args=(), device_types="cpu")
def conv_front_op(wave: Tensor, samples: Tensor, kernel: Tensor, bias: Optional[Tensor],
                  scale: Tensor, shift: Tensor, stride: int, eps: float) -> Tensor:
    """The front as a registered op, so that the dispatcher, and with it
    torch.export, sees one node where the kernel launches. On the CPU it
    is the plain version; on CUDA the kernel (`_conv_front_cuda`)."""
    conv0, group_norm = _params(kernel, bias, scale, shift)
    return conv_front_plain(conv0, group_norm, wave, samples, stride, eps).contiguous()


@conv_front_op.register_fake
def _conv_front_fake(wave, samples, kernel, bias, scale, shift, stride, eps):
    B, T = wave.shape
    return wave.new_empty((B, (T - kernel.shape[-1]) // stride + 1, kernel.shape[0]))


_SIGNATURES = {"conv_front_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_void_p]}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("conv_front", _SIGNATURES)


@conv_front_op.register_kernel("cuda")
def _conv_front_cuda(wave: Tensor, samples: Tensor, kernel: Tensor, bias: Optional[Tensor],
                     scale: Tensor, shift: Tensor, stride: int, eps: float) -> Tensor:
    """The launch: checks what the kernel takes and counts the launch."""
    if wave.dim() != 2 or wave.dtype != torch.bfloat16 or not wave.is_contiguous():
        raise ValueError(f"conv_front: the kernel takes a contiguous bf16 wave [B, T]; "
                         f"got {tuple(wave.shape)} {wave.dtype} "
                         f"(contiguous={wave.is_contiguous()})")
    B, T = wave.shape
    C = kernel.shape[0]
    if not conv_front_supported((kernel.shape[-1],), (stride,), (C,)) \
            or tuple(kernel.shape) != (C, 1, KERNEL):
        raise ValueError(f"conv_front: the kernel takes conv 0 of kernel {KERNEL}, stride "
                         f"{STRIDE} and C % 128 == 0, C <= {MAX_CHANNELS}; got kernel "
                         f"{tuple(kernel.shape)}, stride {stride}")
    if T < KERNEL or not 1 <= B <= 65535:
        raise ValueError(f"conv_front: the kernel takes T >= {KERNEL} and "
                         f"1 <= B <= 65535, got B={B}, T={T}")
    if tuple(samples.shape) != (B,) or samples.dtype != torch.int64:
        raise ValueError(f"conv_front: samples must be int64 [{B}], got "
                         f"{tuple(samples.shape)} {samples.dtype}")
    for t in (samples, kernel, bias, scale, shift):
        if t is not None and t.device != wave.device:
            raise ValueError(f"conv_front: a tensor on {t.device}, wave on {wave.device}")
    for t in (scale, shift):
        if tuple(t.shape) != (C,):
            raise ValueError(f"conv_front: group-norm parameters {tuple(t.shape)} are not [{C}]")
    samples = samples.contiguous()
    w = kernel.to(torch.bfloat16).reshape(C, KERNEL).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    scale, shift = scale.float().contiguous(), shift.float().contiguous()
    stats = torch.empty((B, C, 2), dtype=torch.float32, device=wave.device)
    out = torch.empty((B, (T - KERNEL) // STRIDE + 1, C), dtype=torch.bfloat16,
                      device=wave.device)
    _build.launch("conv_front", _SIGNATURES, "conv_front_bf16", wave.device, wave.data_ptr(),
                  samples.data_ptr(), w.data_ptr(),
                  None if b is None else b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  stats.data_ptr(), out.data_ptr(), B, T, C, eps)
    profiling.launched(LAUNCHES)
    return out


def conv_front(conv0: dict, group_norm: dict, wave: Tensor, samples: Tensor,
               stride: int, eps: float = 1e-5) -> Tensor:
    """Conv 0 (params["convs"][0]: kernel [C, 1, 10], optional bias), the
    masked group norm (params["group_norm"]) over each clip's `samples`
    valid samples, and GELU: wave [B, T] -> [B, T1, C], contiguous. It
    calls `ser_torch::conv_front`: on a CPU tensor the plain version, on a
    CUDA tensor the kernel, which takes bf16 and raises on what it does not
    take; a call that wants a gradient goes by `_build.takes_plain`."""
    if _build.takes_plain("conv_front", wave.device,
                          (wave, *conv0.values(), *group_norm.values())):
        return conv_front_plain(conv0, group_norm, wave, samples, stride, eps)
    return torch.ops.ser_torch.conv_front(wave, samples, conv0["kernel"], conv0.get("bias"),
                                          group_norm["scale"], group_norm["bias"], stride, eps)

