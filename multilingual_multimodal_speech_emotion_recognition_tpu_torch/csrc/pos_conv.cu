// wav2vec2's grouped positional conv (F2): pos = GELU(conv(h) + bias)[:, :T],
// G groups of Cg channels, K taps (even), padding K/2, read from h [B, T, C]
// and written as pos [B, T, C], both bf16, channels-last, no transposes.
//
// Replaces no TPU kernel: the JAX package runs this op as lax.conv, and the
// port's plain version (ops/pos_conv.pos_conv_plain) as a cuDNN grouped
// conv1d over a channels-first view, a bf16 bias add and a tanh GELU.
// Rounding points, as that chain: the product in f32 from bf16 operands,
// rounded to bf16; plus the bias in bf16, rounded; the tanh GELU in f32
// from that bf16 value (torch's formula, F1's gelu_tanh), rounded. Only
// the order of the f32 sums differs. Frame T (the even kernel's extra
// output) is never computed.
//
// Bound on an H100: the products. wav2vec2-base (Cg=48, K=128) costs
// 2 * 768 * 48 * 128 = 9.44 MFLOP a frame, 0.48 TFLOP for a benchmark batch
// of 51k frames, 0.49 ms at the 989 TFLOP/s of bf16 tensor cores; h read
// and pos written once are 160 MB, 0.05 ms at 3.35 TB/s. This design
// meets the operations bound, not an L2 one: each block streams a group's
// weights (590 KB at Cg=48) from L2 once for 4 tiles of 128 frames, 1.2 GB
// a batch, and each tile's 255-row halo once (0.27 GB), about 0.3 ms at
// L2's rate; the tiles round each clip up to 128 frames (0.63 TFLOP done).
//
// Design: a persistent, warp-specialised wgmma GEMM on conv_tail.cu's (A4)
// scaffolding: one TMA producer thread, two consumer warpgroups, an
// mbarrier ring, setmaxnreg. A work item is (group g, 4 tiles), a tile
// being (clip b, 128 output frames t0..t0+127); items walk g fastest, so
// the blocks in flight share the same clips' rows of h and all groups'
// weights (9.4 MB) in L2.
// - Output tile: M = 128 frames (64 a consumer warpgroup), N = Cg (wgmma
//   m64n48k16 or m64n64k16), K = K taps x Cg channels.
// - Halo: each tile loads rows t0 - K/2 .. t0 + 127 + K/2 - 1 of its group's
//   64 channels once, by one TMA box over a 3-D map {C, T, B}. Rows below 0
//   or at T and above, and channels past C, are zero-filled by TMA: that is
//   the conv's zero padding, and a tile never crosses clips. (h is already
//   zero on a clip's padded frames.) Tap j's A operand is then the halo
//   from row j on: the wgmma descriptor's start address moves by j rows of
//   128 bytes (and by 32 bytes a k16 step). The card applies the 128-byte
//   swizzle by the address's own bits, as TMA wrote it, so the base offset
//   stays 0 (set to the row's phase, (addr >> 7) & 7, it garbled every tap
//   off a multiple of 8 on an H100). At Cg=48 each 64-channel row
//   holds the group's 48 channels and 16 it never reads (the first three
//   k16 steps only).
// - Weights: the wrapper repacks them on the card on every call as [C_out,
//   K * Cg] (row g*Cg + o, column j*Cg + c), K-major and dense, so a ring
//   stage (Cg rows x 64 columns, 128-byte swizzled) feeds four k16 steps
//   whatever tap they fall in. They stream through an 8-stage ring, each
//   stage read by the 4 tiles' products of both warpgroups.
// - Epilogue in registers: round, add the bias, round, GELU, round; A4's
//   quad transpose gives each lane 8 consecutive channels of one frame,
//   stored as 16 bytes into the group's channels of [B, T, C]. A block
//   releases its halos as soon as its last product retires, so the next
//   item's halos load while it runs the epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // output frames a tile: 2 consumer warpgroups x 64
constexpr int kBK = 64;          // weight columns a ring stage: 128 bytes
constexpr int kTiles = 4;        // tiles a work item, sharing its weight stream
constexpr int kHaloRows = 256;   // rows kept a tile: 127 + K rounded up, K <= 128
constexpr int kHaloBytes = kHaloRows * 128;
constexpr int kStages = 8;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;    // two consumer warpgroups + one producer

template <int NG>
struct Layout {
  static constexpr int kStageBytes = NG * kBK * 2;  // a multiple of 1024
  static constexpr int kHalos = kTiles * kHaloBytes;
  // halos, ring, the full / empty barriers of the ring and of the halos,
  // and slack to align to 1024 bytes
  static constexpr size_t kSmem =
      (size_t)kHalos + kStages * kStageBytes + (2 * kStages + 2) * 8 + 1024;
};

struct Maps {
  CUtensorMap h;  // h as {C, T, B}, box {64, halo rows, 1}
  CUtensorMap w;  // the packed weights [C_out, K * Cg], box {64, Cg}
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// torch's tanh GELU (ActivationGeluKernel.cu) in f32, as conv_front.cu's
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory descriptor of a K-major operand whose 128-byte rows TMA
// wrote with SWIZZLE_128B into a 1024-byte-aligned tile: 8-row atoms 1024
// bytes apart, base offset 0. `addr` may start on any row of the tile.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x NG f32, the warpgroup's fragment) = a . b^T + (accumulate ? d : 0).
template <int NG>
struct Wgmma;

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void run(float (&d)[24], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Lane q of a quad holds word q of each of four 16-byte chunks (w[c]);
// returns chunk q, all four words, in order (conv_tail.cu's).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int lane) {
  const int q = lane & 3;
  uint32_t got[4];  // got[s]: word (q + s) & 3 of chunk q
#pragma unroll
  for (int s = 0; s < 4; ++s)
    got[s] = __shfl_sync(0xffffffffu, pick(w, (q - s) & 3), (lane & ~3) | ((q + s) & 3));
  return make_uint4(pick(got, (0 - q) & 3), pick(got, (1 - q) & 3), pick(got, (2 - q) & 3),
                    pick(got, (3 - q) & 3));
}

// Two outputs: round(acc) + bias, rounded; GELU, rounded.
__device__ __forceinline__ uint32_t finish_pair(float a0, float a1, __nv_bfloat162 bias) {
  const float z0 = round_bf16(round_bf16(a0) + __low2float(bias));
  const float z1 = round_bf16(round_bf16(a1) + __high2float(bias));
  const __nv_bfloat162 v = __floats2bfloat162_rn(gelu_tanh(z0), gelu_tanh(z1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// pos[b, t, g*NG + o] = GELU(sum_{j, c} w[g*NG + o, j*NG + c] h[b, t + j - K/2,
// g*NG + c] + bias[g*NG + o]) for every tile; grid about one block per SM.
template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
pos_conv_wgmma(const __grid_constant__ Maps maps, const bf16* __restrict__ bias,
               bf16* __restrict__ y, int B, int T, int G, int K, int halo_rows) {
  using S = Layout<NG>;
  constexpr int kChunks = NG / 16;  // k16 steps a tap
  constexpr int kN8 = NG / 8;       // 8-channel column blocks of the fragment
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // SWIZZLE_128B wants 1024-aligned tiles
  const uint32_t ring = base + S::kHalos;
  const uint32_t bars = ring + kStages * S::kStageBytes;
  auto halo = [&](int p) { return base + p * kHaloBytes; };
  auto stage_at = [&](int s) { return ring + s * S::kStageBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t halo_full = bars + 8 * 2 * kStages;
  const uint32_t halo_empty = halo_full + 8;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int C = G * NG;
  const int m_tiles = (T + kBM - 1) / kBM;
  const int group_tiles = B * m_tiles;           // tiles of one group
  const int chunks = (group_tiles + kTiles - 1) / kTiles;
  const int items = G * chunks;
  const int k_steps = K * kChunks;               // k16 steps an item
  const int n_stages = (k_steps + 3) / 4;        // ring stages an item

  if (tid >= 2 * 128) {
    // ---- producer warpgroup: one thread keeps the halos and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0, halo_phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int g = item % G, first = (item / G) * kTiles;
        const int np = min(kTiles, group_tiles - first);
        mbar_wait(halo_empty, halo_phase ^ 1);
        mbar_expect_tx(halo_full, np * halo_rows * 128);
        for (int p = 0; p < np; ++p) {
          const int tile = first + p;
          tma_load_3d(halo(p), &maps.h, halo_full, g * NG, (tile % m_tiles) * kBM - K / 2,
                      tile / m_tiles);
        }
        halo_phase ^= 1;
        for (int q = 0; q < n_stages; ++q) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), S::kStageBytes);
          tma_load_2d(stage_at(stage), &maps.w, full(stage), q * kBK, g * NG);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64*wg .. 64*wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0, halo_phase = 0;
    float acc[kTiles][NG / 2];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int g = item % G, first = (item / G) * kTiles;
      const int np = min(kTiles, group_tiles - first);
      mbar_wait(halo_full, halo_phase);
      halo_phase ^= 1;
      int last = stage, j = 0, c = 0;  // the tap and the 16-channel chunk of step s
      for (int q = 0; q < n_stages; ++q) {
        mbar_wait(full(stage), phase);
        const uint32_t bt = stage_at(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of the stage's rows per k16 step
          const int s = 4 * q + kk;
          if (s < k_steps) {
            const uint64_t b_desc = smem_desc(bt + 32 * kk);
            const uint32_t a_off = (64 * wg + j) * 128 + 32 * c;
#pragma unroll
            for (int p = 0; p < kTiles; ++p)
              if (p < np)
                Wgmma<NG>::run(acc[p], smem_desc(halo(p) + a_off), b_desc, s > 0);
            if (++c == kChunks) {
              c = 0;
              ++j;
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have read it
        if (q > 0 && lane == 0) mbar_arrive(empty(last));
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(empty(last));
        mbar_arrive(halo_empty);
      }

      // Fragment: acc[p][4j + 2i + e] is frame row 16*warp + lane/4 + 8i of
      // the warpgroup's 64, channel 8j + 2(lane%4) + e of the group.
      const int n0 = g * NG;
      const int qd = lane & 3;
#pragma unroll
      for (int p = 0; p < kTiles; ++p) {
        if (p >= np) break;
        const int tile = first + p;
        const int b = tile / m_tiles;
        const int t = (tile % m_tiles) * kBM + wg * 64 + warp * 16 + lane / 4 + (qd & 1) * 8;
        bf16* yrow = y + ((size_t)b * T + t) * C + n0;
#pragma unroll
        for (int jj = 0; jj < kN8 / 2; ++jj) {  // column blocks 2jj and 2jj+1
          uint32_t w[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {  // chunk cc: row half cc&1, block 2jj + cc/2
            const int jb = 2 * jj + cc / 2, i = cc & 1;
            const __nv_bfloat162 bv =
                *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + 8 * jb + 2 * qd);
            w[cc] = finish_pair(acc[p][4 * jb + 2 * i], acc[p][4 * jb + 2 * i + 1], bv);
          }
          const uint4 v = quad_transpose(w, lane);  // chunk qd: row half qd&1, block 2jj + qd/2
          if (t < T) *reinterpret_cast<uint4*>(yrow + 8 * (2 * jj + qd / 2)) = v;
        }
      }
    }
  }
}

// A 128-byte-swizzled bf16 tensor map of `rank` dims (innermost first);
// elements outside the tensor read as zeros.
bool encode_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                                const_cast<void*>(base), dims, strides, box, ones,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NG>
cudaError_t launch(const Maps& maps, const bf16* bias, bf16* y, int B, int T, int G, int K,
                   int halo_rows, cudaStream_t stream) {
  using S = Layout<NG>;
  cudaError_t err = cudaFuncSetAttribute(
      pos_conv_wgmma<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long group_tiles = (long long)B * ((T + kBM - 1) / kBM);
  const long long items = (long long)G * ((group_tiles + kTiles - 1) / kTiles);
  const int grid = (int)(items < sms ? items : sms);
  pos_conv_wgmma<NG><<<grid, kThreads, S::kSmem, stream>>>(maps, bias, y, B, T, G, K,
                                                           halo_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos [B, T, C] = GELU(grouped conv(h) + bias), frames 0..T-1, on `stream`.
// h [B, T, C] bf16; w [C, K * Cg] bf16, row g*Cg + o holding kernel[g*Cg + o,
// c, j] at column j*Cg + c; bias [C] bf16. C = G * Cg with Cg 48 or 64;
// K even, 2..128. All contiguous and 16-byte aligned. Returns the CUDA
// error of the launch (0 on success); asynchronous.
int pos_conv_bf16(const void* h, const void* w, const void* bias, void* pos, int B, int T,
                  int G, int Cg, int K, void* stream) {
  if (B < 1 || T < 1 || G < 1 || (Cg != 48 && Cg != 64) || K < 2 || K > 128 || K % 2)
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)G * Cg;
  const int halo_rows = (kBM - 1 + K + 7) / 8 * 8;
  Maps maps;
  const cuuint64_t h_dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t h_strides[2] = {(cuuint64_t)2 * C, (cuuint64_t)2 * T * C};
  const cuuint32_t h_box[3] = {kBK, (cuuint32_t)halo_rows, 1};
  if (!encode_map(&maps.h, h, 3, h_dims, h_strides, h_box)) return (int)cudaErrorInvalidValue;
  const cuuint64_t w_dims[2] = {(cuuint64_t)K * Cg, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)2 * K * Cg};
  const cuuint32_t w_box[2] = {kBK, (cuuint32_t)Cg};
  if (!encode_map(&maps.w, w, 2, w_dims, w_strides, w_box)) return (int)cudaErrorInvalidValue;
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* y = static_cast<bf16*>(pos);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(Cg == 48 ? launch<48>(maps, b, y, B, T, G, K, halo_rows, s)
                        : launch<64>(maps, b, y, B, T, G, K, halo_rows, s));
}

const char* pos_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
