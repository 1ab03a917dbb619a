"""The classifier's eval-path residual stack: a hand-written CUDA kernel
(csrc/residual_stack.cu) and its plain PyTorch version.

Replaces the TPU kernel `residual_stack_pallas`
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:114),
which keeps the [B, D] activation in VMEM while the L layers' weights
stream in. Per layer: y = LN_pre(h); h = y + (relu(LN_blk(y) @ W1 + b1)
@ W2 + b2), f32, LN eps 1e-5.

Bound on an H100: one read of the weights, L * 2 * D * D * 4 bytes (73.4 MB
at the flagship's L=35, D=512), about 22 us at 3.35 TB/s for a small batch;
at B=128 the f32 FMAs on the CUDA cores (4.7 GFLOP at 67 TFLOP/s, ~70 us)
bound it instead. The kernel's design keeps each block's rows in shared
memory across all layers, so the activation never goes back to device
memory; see the source for how the products are laid out and why a small
batch sits far above the bound.

`residual_stack` takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import layers
from . import _build

Tensor = torch.Tensor

_VECTORS = (("ln_pre", "scale"), ("ln_pre", "bias"),
            ("block_ln", "scale"), ("block_ln", "bias"))


def residual_stack_plain(stacked: dict, x: Tensor) -> Tensor:
    """A Python loop over the L layers, mirroring the JAX package's
    models/classifier.py:_residual_stack with deterministic=True."""
    h = x
    for i in range(stacked["block_lin1"]["kernel"].shape[0]):
        layer = layers.layer_at(stacked, i)
        y = layers.layer_norm(layer["ln_pre"], h)
        b = layers.layer_norm(layer["block_ln"], y)
        b = torch.relu(layers.linear(layer["block_lin1"], b))
        b = layers.linear(layer["block_lin2"], b)
        h = y + b
    return h


_SIGNATURES = {"residual_stack_f32": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("residual_stack", _SIGNATURES)


def residual_stack(stacked: dict, x: Tensor) -> Tensor:
    """Eval-path residual stack. stacked: the classifier's [L, ...] layer
    parameters; x: [B, D] f32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, or raises on what the kernel does not take."""
    if x.device.type == "cpu":
        return residual_stack_plain(stacked, x)
    if x.device.type != "cuda":
        raise ValueError(f"residual_stack: no kernel for device {x.device}")
    w1 = stacked["block_lin1"]["kernel"]
    w2 = stacked["block_lin2"]["kernel"]
    L, D = w1.shape[:2]
    if x.dim() != 2 or x.shape[1] != D or x.shape[0] < 1:
        raise ValueError(f"residual_stack: x {tuple(x.shape)} is not [B, {D}]")
    if D % 4 != 0 or D > 2048:
        raise ValueError(f"residual_stack: the kernel takes D % 4 == 0 and "
                         f"D <= 2048, got D={D}")
    args = [x, *(stacked[a][b] for a, b in _VECTORS), w1,
            stacked["block_lin1"]["bias"], w2, stacked["block_lin2"]["bias"]]
    shapes = [(x.shape[0], D)] + [(L, D)] * 4 + [(L, D, D), (L, D), (L, D, D), (L, D)]
    for t, shape in zip(args, shapes):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"residual_stack: the kernel takes contiguous f32 tensors on "
                f"{x.device} of shape {shape}; got {tuple(t.shape)} "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty_like(x)
    _build.launch("residual_stack", _SIGNATURES, "residual_stack_f32", x.device,
                  *(t.data_ptr() for t in args), out.data_ptr(), x.shape[0], L, D)
    residual_stack.launches += 1
    return out


residual_stack.launches = 0
