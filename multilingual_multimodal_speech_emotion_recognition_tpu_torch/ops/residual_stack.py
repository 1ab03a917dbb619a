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
bound it instead. The 2L products form a chain, each needing all of the
one before, so the kernel is one cooperative grid that spreads every
product over the card: each block owns a strip of output columns and some
groups of batch rows (`plan`), the grid meets at a hand-written barrier
after each product, and each block's weight strips stream by tensor copies
into a shared-memory ring ahead of the chain, so the weight reads leave
the critical path. What is left on it is latency: the barrier, the L2
round trip of the exchanged rows, the LNs and each product's reduction.
See the source for the phases and the ring.

`residual_stack` takes the plain version for a tensor on the CPU only; for a
CUDA tensor it launches the kernel or raises. The kernel has no backward
and writes its output through a raw pointer, so that output carries no
autograd history: on a CUDA tensor the wrapper raises where autograd is
recording and x or a layer parameter wants a gradient, instead of cutting
the gradients above it to zero without a word. The training forward takes
the classifier's plain loop (models/classifier.py), as the JAX package
keeps its scan there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from ..models import layers
from . import _build

Tensor = torch.Tensor

_VECTORS = (("ln_pre", "scale"), ("ln_pre", "bias"),
            ("block_ln", "scale"), ("block_ln", "bias"))

# What csrc/residual_stack.cu takes; plan() keeps to it.
WARPS = 8                        # 256 threads a block
MAX_SMEM = 232_448               # bytes of shared memory a block may use
BLOCKS_PER_SM = 1                # the ring fills one SM's shared memory
ROW_GROUP_SIZES = (4, 8, 16)     # rows a block's accumulators hold
# Column strips the plan picks from (the kernel takes any cw / 4 that
# divides a warp). Timed on an H100 at D=512 (PERF.md): 4 columns were no
# faster than 8 at B=4, 64 slower than 32 at B=128.
COL_WIDTHS = (8, 16, 32)


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


class Plan(NamedTuple):
    """How the kernel cuts [B, D] over its grid. Block b owns the columns
    [c0, c0 + col_width) with c0 = (b % col_groups) * col_width (the last
    group cut at D), and the row groups b // col_groups, + row_blocks, ...
    of `rows` rows each."""
    batch: int
    width: int           # D
    rows: int
    col_width: int
    col_groups: int
    row_blocks: int
    depth: int           # weight strips the shared-memory ring holds
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.col_groups * self.row_blocks

    @property
    def row_groups(self) -> int:
        return -(-self.batch // self.rows)

    def tiles(self, block: int) -> Iterator[Tuple[int, int, int, int]]:
        """(row_start, row_stop, col_start, col_stop) of each tile the
        block computes, as the kernel indexes them."""
        c0 = (block % self.col_groups) * self.col_width
        for g in range(block // self.col_groups, self.row_groups, self.row_blocks):
            yield (g * self.rows, min(self.batch, (g + 1) * self.rows),
                   c0, min(self.width, c0 + self.col_width))


def slot_floats(D: int, col_width: int) -> int:
    """csrc/residual_stack.cu:slot_floats: one ring slot, a strip of D rows
    (zero-padded to whole tensor copies of at most 256 rows k / 4, 8 at a
    time), four LN vectors and col_width biases, on 128 bytes."""
    boxes = -(-D // 4 // 256)
    plane = boxes * ((-(-(D // 4) // boxes) + 7) // 8 * 8)
    return (4 * plane * col_width + 4 * D + col_width + 31) // 32 * 32


def smem_bytes(rows: int, D: int, col_width: int, depth: int) -> int:
    """csrc/residual_stack.cu:smem_bytes: slack to align the ring to 128
    bytes, the ring, its mbarriers, the [rows, D] activation and the warps'
    partial sums."""
    barriers = (8 * depth + 15) // 16 * 16
    return (128 + 4 * depth * slot_floats(D, col_width) + barriers
            + 4 * (rows * D + WARPS * rows * col_width))


@functools.lru_cache(maxsize=256)
def plan(B: int, L: int, D: int, num_sms: int) -> Plan:
    """The kernel's grid for a [B, D] input and L layers on a card of
    `num_sms` SMs that hold BLOCKS_PER_SM blocks each.

    Rows come in groups of 4, 8 or 16 (the fewest that hold B, up to 16).
    Among the column widths that fit the shared memory with a ring of at
    least one strip, it takes the one whose blocks each do the least work
    (row groups x columns per block), and of equals the widest: fewer
    blocks recompute the LNs and read each exchanged row. The ring is as
    deep as the rest allows. Raises ValueError where nothing fits."""
    rows_first = next(r for r in ROW_GROUP_SIZES if r >= min(B, ROW_GROUP_SIZES[-1]))
    capacity = num_sms * BLOCKS_PER_SM
    budget = MAX_SMEM // BLOCKS_PER_SM
    for rows in reversed([r for r in ROW_GROUP_SIZES if r <= rows_first]):
        row_groups = -(-B // rows)
        best = None
        for w in COL_WIDTHS:
            col_groups = -(-D // w)
            if col_groups > capacity:
                continue
            depth = min(2 * L, (budget - smem_bytes(rows, D, w, 0)) // (4 * slot_floats(D, w)))
            while depth >= 1 and smem_bytes(rows, D, w, depth) > budget:
                depth -= 1
            if depth < 1:
                continue
            row_blocks = min(row_groups, capacity // col_groups)
            key = (-(-row_groups // row_blocks) * w, -w)
            if best is None or key < best[0]:
                best = (key, Plan(B, D, rows, w, col_groups, row_blocks, depth,
                                  smem_bytes(rows, D, w, depth)))
        if best is not None:
            return best[1]
    raise ValueError(f"residual_stack: no grid fits B={B}, D={D} on {num_sms} SMs")


_SIGNATURES = {"residual_stack_f32": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
               + [ctypes.c_void_p]}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("residual_stack", _SIGNATURES)


def residual_stack(stacked: dict, x: Tensor) -> Tensor:
    """Eval-path residual stack. stacked: the classifier's [L, ...] layer
    parameters; x: [B, D] f32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel, or raises on what the kernel does not take,
    a gradient included."""
    if x.device.type == "cpu":
        return residual_stack_plain(stacked, x)
    if x.device.type != "cuda":
        raise ValueError(f"residual_stack: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for sub in stacked.values() for t in sub.values())):
        raise RuntimeError(
            "residual_stack: the CUDA kernel has no backward; run the eval forward "
            "under torch.no_grad() or torch.inference_mode(), and train through "
            "the classifier's plain stack (deterministic=False)")
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
        if t.data_ptr() % 16:
            raise ValueError("residual_stack: the kernel takes 16-byte aligned tensors")
    B = x.shape[0]
    p = plan(B, L, D, torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty_like(x)
    exchange = torch.empty(2, B, D, dtype=torch.float32, device=x.device)  # u, y
    arrivals = torch.zeros(1, dtype=torch.int32, device=x.device)
    _build.launch("residual_stack", _SIGNATURES, "residual_stack_f32", x.device,
                  *(t.data_ptr() for t in args), out.data_ptr(), exchange[0].data_ptr(),
                  exchange[1].data_ptr(), arrivals.data_ptr(), B, L, D, p.rows,
                  p.col_width, p.col_groups, p.row_blocks, p.depth)
    residual_stack.launches += 1
    return out


residual_stack.launches = 0
