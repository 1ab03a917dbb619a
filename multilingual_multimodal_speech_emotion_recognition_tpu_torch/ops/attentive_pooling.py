"""Streaming masked attentive-statistics pooling: a hand-written CUDA kernel
(csrc/attentive_pooling.cu) and its plain PyTorch version.

Replaces the TPU kernel `attentive_stats_pooling_pallas`
(multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:208,
body `_pool_kernel` :161), with that kernel's masking, not the model's
`ops/pooling.attentive_stats_pooling`'s: masked frames get a score of
-1e30 (not -inf) and are also multiplied out of the weights, the
normaliser is clamped at 1e-30, and std = sqrt(var + 1e-6). The TPU kernel
takes var = E[x^2] - mean^2; where a row's weight sits on one frame that
difference is a few f32 ulps of x^2 and moves std by up to 4e-4 through
the square root at its 1e-6 floor. So the plain version takes the
variance about the mean (two passes) and the f32 route a running mean and
sum of squared deviations; the bf16 route, whose bf16 output rounds far
more than that, keeps E[x^2] - mean^2. The arithmetic is f32, except that
the bf16 route multiplies bf16 x by bf16 W1 (exact products, f32 sums) and
takes tanh on the special-function unit; the output [B, 2D] is in x.dtype.

The route is chosen by the dtypes of x and W1 (`ROUTES`, `route`):
- "bf16" (bf16 x, bf16 W1): the tensor-core kernel. Tiles of 64 rows
  (frames of one batch row, or several short rows packed together) arrive
  by TMA as bf16 and stay in shared memory; the score MLP runs on `wgmma`
  with W1 streamed in chunks through an mbarrier ring; each batch row's
  tiles are spread over a cluster of up to 8 blocks that combine their
  partial softmax sums through distributed shared memory. `plan` cuts the
  work. A bf16 x whose rows are not whole 16-byte units (D % 8 != 0) or
  whose data is not 16-byte aligned cannot be described to TMA and takes
  the f32 route, with W1 widened to f32 (exact).
- "f32" (f32 x; bf16 x with f32 W1): one block per batch row on the CUDA
  cores in f32, 32-frame f32 tiles of x in shared memory. Rounding an f32
  W1 to bf16 would change the result, so bf16 x with f32 W1 comes here.

Like the JAX package (ops/pooling.py:8-13), nothing under `models/` calls
this: the model pools through `ops/pooling.py`. `attentive_stats_pooling`
takes the plain version for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from ..utils import profiling
from . import _build

Tensor = torch.Tensor

NEG_BIG = -1e30
LAUNCHES = profiling.launch_key("attentive_stats_pooling")
POOL_EPS = 1e-6
# D's limit: the f32 route's [32, D] f32 tile, and the bf16 route's
# [64, D] bf16 tile beside its W1 ring, fit a block's shared memory.
MAX_D = 1536
_DTYPES = (torch.bfloat16, torch.float32)
_HIDDEN = (32, 64, 128, 256)

# The route by (x dtype, W1 dtype): "bf16" is the tensor-core kernel, "f32"
# the CUDA-core kernel.
ROUTES = {(torch.bfloat16, torch.bfloat16): "bf16", (torch.bfloat16, torch.float32): "f32",
          (torch.float32, torch.float32): "f32", (torch.float32, torch.bfloat16): "f32"}

# What the bf16 route's kernel (csrc/attentive_pooling.cu:pool_wgmma) takes;
# plan() keeps to it.
TILE_ROWS = 64             # rows of a tile: one wgmma M
MAX_SMEM = 232_448         # bytes of shared memory a block may use
MAX_CLUSTER = 8            # portable cluster size
CHUNKS = (128, 64, 32, 16)  # W1 rows per ring slot
MAX_DEPTH = 8              # ring slots


def attentive_stats_pooling_plain(params: dict, x: Tensor, mask: Tensor) -> Tensor:
    """The kernels' function over the whole sequence at once, in f32: the
    mean, then the variance about it."""
    xf = x.float()
    mf = mask.float()
    h = torch.tanh(xf @ params["w1"]["kernel"].float() + params["w1"]["bias"].float())
    sc = (h @ params["w2"]["kernel"].float()).squeeze(-1) + params["w2"]["bias"].float()
    sc = sc.masked_fill(mf == 0, NEG_BIG)
    e = torch.exp(sc - sc.amax(-1, keepdim=True)) * mf
    l = e.sum(-1, keepdim=True).clamp(min=1e-30)
    mean = torch.einsum("bs,bsd->bd", e, xf) / l
    var = torch.einsum("bs,bsd->bd", e, (xf - mean[:, None, :]).square()) / l
    std = torch.sqrt(var.clamp(min=0.0) + POOL_EPS)
    return torch.cat([mean, std], dim=-1).to(x.dtype)


def route(x_dtype: torch.dtype, w1_dtype: torch.dtype, D: int, x_ptr: int) -> str:
    """The route a CUDA x of this dtype, width and address takes with a W1
    of this dtype: ROUTES, except that the bf16 route's tensor map needs
    16-byte rows and a 16-byte aligned x."""
    name = ROUTES[(x_dtype, w1_dtype)]
    if name == "bf16" and (D % 8 or x_ptr % 16):
        return "f32"
    return name


class Plan(NamedTuple):
    """How the bf16 route cuts [B, S, D] over its grid. A tile is `rows`
    batch rows x `seg` frames (tile row r = batch row r // seg, frame
    r % seg); a batch row has `tiles_per_row` tiles of `seg` frames. Block
    i is rank i % cluster of its cluster and serves row group i // cluster
    (batch rows `rows` * group ..); it takes that group's tiles rank *
    tiles .. + tiles - 1 and the clusters' blocks combine their sums. W1
    streams in `chunk`-row slots through a ring of `depth`."""
    batch: int
    frames: int          # S
    width: int           # D
    hidden: int          # H
    seg: int
    rows: int
    cluster: int
    tiles: int
    chunk: int
    depth: int
    smem_bytes: int

    @property
    def tiles_per_row(self) -> int:
        return -(-self.frames // self.seg)

    @property
    def groups(self) -> int:
        return -(-self.batch // self.rows)

    @property
    def blocks(self) -> int:
        return self.cluster * self.groups

    def pieces(self, block: int) -> Iterator[Tuple[int, int, int]]:
        """(batch row, first frame, frame stop) of each piece of the input
        the block reads, as the kernel indexes them."""
        rank, group = block % self.cluster, block // self.cluster
        for t in range(rank * self.tiles, min((rank + 1) * self.tiles, self.tiles_per_row)):
            for r in range(self.rows):
                b = group * self.rows + r
                if b < self.batch:
                    yield b, t * self.seg, min(self.frames, (t + 1) * self.seg)


def smem_bytes(D: int, H: int, chunk: int, depth: int, cluster: int) -> int:
    """csrc/attentive_pooling.cu:wgmma_smem_bytes: slack to align to 1024
    bytes, x's 64-column panels of 64 rows, the W1 ring, the mbarriers (one
    per x panel, a full and an empty one per slot, one that frees x; to 16
    bytes), b1 and w2, five 64-entry vectors (mask, scores, running max,
    normaliser, rescale) and, in a cluster, the combine's receive buffer:
    each block's sums of this block's 8-channel units and its (m, l)."""
    panels = -(-D // 64)
    nb = max(64, H) // 64
    per = -(-panels * 8 // cluster)
    rx = 0 if cluster == 1 else 16 * cluster * per + 2 * cluster
    return (1024 + panels * 64 * 128 + depth * nb * chunk * 128
            + -(-8 * (panels + 2 * depth + 1) // 16) * 16
            + 4 * (2 * 64 * nb + 5 * TILE_ROWS + rx))


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, D: int, H: int, num_sms: int) -> Plan:
    """The bf16 route's grid for x [B, S, D] and H hidden units on a card of
    `num_sms` SMs, one block an SM (a 64-frame tile of x and the W1 ring
    fill its shared memory).

    A sequence longer than half a tile is cut into 64-frame tiles, and a
    batch row's tiles go to a cluster of blocks: the fewest blocks per row
    that still give every SM a block (up to 8; each takes the same number
    of tiles). A block streams all of W1 once per tile and works through
    its tiles in turn, so a few rows spread over many SMs (B=4 at the
    flagship's audio site: 16 blocks) while many rows keep each block's
    combine and start-up to a few tiles (B=128: 256 blocks of 2 tiles).
    A shorter sequence takes `seg` = the next power of two of frames per
    row, and rows are packed into a tile only when the batch has more rows
    than the card has SMs. W1 streams in the largest chunks (up to 128
    rows) that leave room for a ring of at least two, as deep as shared
    memory allows (up to 8): a W1 chunk costs about the same whatever its
    size (scripts/torch_pool_plan_sweep.py)."""
    seg = TILE_ROWS if S > TILE_ROWS // 2 else 1 << (S - 1).bit_length()
    tiles_per_row = -(-S // seg)
    if tiles_per_row == 1:
        # whole rows in a tile: pack rows only once there are more rows than SMs
        rows = max(1, min(TILE_ROWS // seg, B // num_sms))
        cluster = tiles = 1
    else:
        # the fewest blocks per row that still give every SM a block
        rows = 1
        sizes = sorted({-(-tiles_per_row // -(-tiles_per_row // c))
                        for c in range(1, min(MAX_CLUSTER, tiles_per_row) + 1)})
        cluster = next((c for c in sizes if B * c >= num_sms), sizes[-1])
        tiles = -(-tiles_per_row // cluster)
    padded = -(-D // 64) * 64
    for chunk in CHUNKS:
        if padded % chunk:
            continue  # a slot never straddles two tiles
        depth = min(MAX_DEPTH, tiles * padded // chunk)
        while depth >= 1 and smem_bytes(D, H, chunk, depth, cluster) > MAX_SMEM:
            depth -= 1
        if depth >= min(2, tiles * padded // chunk):
            return Plan(B, S, D, H, seg, rows, cluster, tiles, chunk, depth,
                        smem_bytes(D, H, chunk, depth, cluster))
    raise ValueError(f"attentive_stats_pooling: no bf16 plan fits D={D}, H={H} "
                     f"in {MAX_SMEM} bytes of shared memory")


_F32_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
STAMPS = 10  # values a block writes for a timed breakdown (csrc: kStamps)
_SIGNATURES = {"attentive_pooling_bf16": _F32_ARGTYPES, "attentive_pooling_f32": _F32_ARGTYPES,
               "attentive_pooling_wgmma": _WGMMA_ARGTYPES}


def build() -> None:
    """Compile and load the kernel now instead of at its first launch."""
    _build.load("attentive_pooling", _SIGNATURES)


def _launch_bf16(params: dict, x: Tensor, mask: Tensor, p: Plan,
                 stamps: Tensor | None = None) -> Tensor:
    """The bf16 route under plan `p`: bf16 x, bf16 W1; b1, w2, b2 as they
    come if all bf16, else widened to f32. `stamps`, an int64 tensor of
    p.blocks * STAMPS on x's device, takes each block's phase times
    (scripts/torch_pool_breakdown.py reads them)."""
    B, S, D = x.shape
    w1 = params["w1"]["kernel"].contiguous()
    if w1.data_ptr() % 16:
        w1 = w1.clone()
    vecs = [params["w1"]["bias"], params["w2"]["kernel"], params["w2"]["bias"]]
    vec_bf16 = all(v.dtype == torch.bfloat16 for v in vecs)
    vecs = [v.contiguous() if vec_bf16 else v.to(torch.float32).contiguous() for v in vecs]
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((B, 2 * D), dtype=torch.bfloat16, device=x.device)
    _build.launch("attentive_pooling", _SIGNATURES, "attentive_pooling_wgmma", x.device,
                  x.data_ptr(), mask.data_ptr(), w1.data_ptr(),
                  *(v.data_ptr() for v in vecs), int(vec_bf16), out.data_ptr(),
                  0 if stamps is None else stamps.data_ptr(), B, S, D, w1.shape[1],
                  p.seg, p.rows, p.cluster, p.tiles, p.chunk, p.depth)
    return out


def attentive_stats_pooling(params: dict, x: Tensor, mask: Tensor) -> Tensor:
    """params: {"w1": {kernel [D, H], bias [H]}, "w2": {kernel [H, 1], bias
    [1]}}; x: [B, S, D]; mask: [B, S] (1 valid / 0 pad) -> [B, 2D] in
    x.dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel of its route (recorded in `.last_route`), or raises on what
    it does not take."""
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
    if x.dtype not in _DTYPES or w1.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"attentive_stats_pooling: the kernel takes a "
                         f"contiguous bf16 or f32 x and a bf16 or f32 w1; got "
                         f"x {x.dtype} (contiguous={x.is_contiguous()}), w1 {w1.dtype}")
    if D % 4 != 0 or D > MAX_D or H not in _HIDDEN:
        raise ValueError(f"attentive_stats_pooling: the kernel takes D % 4 == 0, "
                         f"D <= {MAX_D} and H in {_HIDDEN}; got D={D}, H={H}")
    for t in (mask, w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"attentive_stats_pooling: a tensor on {t.device}, "
                             f"x on {x.device}")
    name = route(x.dtype, w1.dtype, D, x.data_ptr())
    if name == "bf16":
        num_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        out = _launch_bf16(params, x, mask, plan(B, S, D, H, num_sms))
    else:
        f32 = [t.to(torch.float32).contiguous() for t in (mask, w1, b1, w2, b2)]
        out = torch.empty((B, 2 * D), dtype=x.dtype, device=x.device)
        entry = ("attentive_pooling_bf16" if x.dtype == torch.bfloat16
                 else "attentive_pooling_f32")
        _build.launch("attentive_pooling", _SIGNATURES, entry, x.device, x.data_ptr(),
                      *(t.data_ptr() for t in f32), out.data_ptr(), B, S, D, H)
    profiling.launched(LAUNCHES)
    attentive_stats_pooling.last_route = name
    return out


attentive_stats_pooling.last_route = None
