// wav2vec2 conv-extractor tail: conv layers 1-6 (kernels 3,3,3,3,2,2, all
// stride 2, C channels in and out), each followed by its bias, an optional
// per-frame LayerNorm over C, and GELU.
//
// Replaces the TPU kernel conv_tail_pallas
// (multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:467,
// body _conv_tail_kernel :423). Per layer: the product in f32 from operands
// in the working type, rounded once to it; + bias in the working type;
// optional LN with f32 moments, rounded; GELU (tanh approximation in bf16,
// erf in f32), rounded.
//
// Bound on an H100: the products. At wav2vec2-base width (C=512) and 4 s
// clips, layers 1-6 are 2.50 TFLOP at B=128, 2.52 ms at the 989 TFLOP/s of
// bf16 tensor cores; reading x1 (1.68 GB) takes 0.5 ms at 3.35 TB/s, and
// with the intermediates this design writes and reads back, about 4.9 GB,
// 1.5 ms.
//
// Layout: channels-last ([B, T, C]), so the window of output frame t,
// x[b, 2t : 2t+K, :], is K*C contiguous values and each layer is one GEMM:
// A is the overlapping-row view [T_out, K*C] of the input (row stride 2C),
// B the layer's weights packed K-major as [C_out, K*C_in]. No im2col copy.
// One launch per layer; the intermediates go through device memory (the
// TPU kernel's tile+halo scheme kept them in VMEM to feed the MXU, which a
// GEMM per layer does not need).
//
// bf16 design: a persistent, warp-specialised wgmma GEMM, about one block
// per SM walking the (batch, frame tile, channel tile) space, channel tiles
// fastest so that neighbouring blocks share their A rows in L2.
// - A operand: one TMA tensor map per tap j, 3-D {C, T_out, B} with byte
//   strides {4C, 2 T_in C}, based at x + j*C. The window row x[b, 2t+j, :]
//   is then a plain strided row, no map overlaps itself, TMA zero-fills the
//   frames past T_out, and a tile never crosses batch rows.
// - K loop over (tap, 64-channel chunk): 128-byte rows, which is what
//   SWIZZLE_128B and wgmma's 128-byte-swizzled K-major operands want.
// - A ring of 4 stages of 128 frames x 64 and C_tile x 64 values, each
//   guarded by a full and an empty mbarrier. One producer thread issues
//   cp.async.bulk.tensor; two consumer warpgroups each run wgmma
//   m64n128k16 (bf16 in, f32 accumulate) on 64 of the 128 frames, over a
//   256-channel tile (128 where C is not a multiple of 256), and release a
//   stage as soon as the wgmma that read it has retired. setmaxnreg moves
//   registers from the producer to the consumers.
// - Epilogue in registers: round, add the bias, round, GELU, round; a
//   transpose within each quad of lanes gives every lane 8 consecutive
//   channels of one frame, stored as 16 bytes. The producer meanwhile
//   fills the ring with the next tile, so the epilogue overlaps its loads,
//   but not the next tile's products: the epilogue's arithmetic (GELU and
//   three roundings per value) is what keeps the kernel from the rate of
//   its main loop. Giving each consumer warpgroup whole tiles in turn
//   (ping-pong) did not hide it on an H100 and was not kept.
// f32 design: a 64x64 tile of CUDA-core FMAs. With LN the epilogue stops
// after the bias and one warp per frame applies LN and GELU in a second
// pass.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLayers = 6;
constexpr int kTaps[kLayers] = {3, 3, 3, 3, 2, 2};
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// Rounding to the working type and its GELU.
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float gelu_of(float v, bf16) { return gelu_tanh(v); }
__device__ __forceinline__ float gelu_of(float v, float) { return gelu_erf(v); }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// round(acc) + bias, rounded; then GELU, rounded, unless LN follows.
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float bias, bool gelu) {
  float z = round_to(round_to(acc, T{}) + bias, T{});
  return gelu ? round_to(gelu_of(z, T{}), T{}) : z;
}

// ----------------------------------------------------- bf16: TMA + wgmma

constexpr int kBM = 128;  // output frames per tile: 2 consumer warpgroups x 64
constexpr int kBK = 64;   // channels per K step: 128 bytes
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kGemmThreads = 384;  // two consumer warpgroups + one producer

// NB: 128-channel halves of the block's channel tile (1 or 2).
template <int NB>
struct Tile {
  static constexpr int kBN = 128 * NB;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // stages, the full and empty barriers, and slack to align to 1024 bytes
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

struct TailMaps {
  CUtensorMap a[3];  // per tap j: x[b, 2t + j, c] as {C, T_out, B}
  CUtensorMap w;     // the layer's packed weights [C_out, K*C_in]
};

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

// Shared-memory descriptor of a K-major operand tile whose 128-byte rows
// TMA wrote with SWIZZLE_128B: 8-row atoms 1024 bytes apart.
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

// d (64 x 128 f32, the warpgroup's fragment) = a . b^T + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Lane q of a quad holds word q of each of four 16-byte chunks (w[c]);
// returns chunk q, all four words, in order.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int lane) {
  const int q = lane & 3;
  uint32_t got[4];  // got[s]: word (q + s) & 3 of chunk q
#pragma unroll
  for (int s = 0; s < 4; ++s)
    got[s] = __shfl_sync(0xffffffffu, pick(w, (q - s) & 3), (lane & ~3) | ((q + s) & 3));
  return make_uint4(pick(got, (0 - q) & 3), pick(got, (1 - q) & 3), pick(got, (2 - q) & 3),
                    pick(got, (3 - q) & 3));
}

__device__ __forceinline__ uint32_t finish_pair(float a0, float a1, __nv_bfloat162 bias,
                                                bool gelu) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(
      epilogue<bf16>(a0, __low2float(bias), gelu), epilogue<bf16>(a1, __high2float(bias), gelu));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y[b, t, :] = epilogue(x[b, 2t : 2t+K, :] (flattened) @ w^T) for every
// tile of (b, 128 frames, 128*NB channels); grid about one block per SM.
template <int NB>
__global__ void __launch_bounds__(kGemmThreads, 1)
conv_layer_wgmma(const __grid_constant__ TailMaps maps, const bf16* __restrict__ bias,
                 bf16* __restrict__ y, int B, int T_out, int C, int K, int gelu) {
  using S = Tile<NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // SWIZZLE_128B wants 1024-aligned tiles
  const uint32_t bars = base + kStages * S::kStageBytes;
  auto a_tile = [&](int s) { return base + s * S::kStageBytes; };
  auto b_tile = [&](int s) { return base + s * S::kStageBytes + S::kABytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (T_out + kBM - 1) / kBM;
  const int n_tiles = C / S::kBN;
  const int tiles = B * m_tiles * n_tiles;
  const int chunks = C / kBK;     // K steps per tap
  const int k_steps = K * chunks;

  if (tid >= 2 * 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int nt = tile % n_tiles, mt = (tile / n_tiles) % m_tiles;
        const int b = tile / (n_tiles * m_tiles);
        for (int ks = 0; ks < k_steps; ++ks) {
          const int j = ks / chunks, c0 = (ks % chunks) * kBK;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), S::kStageBytes);
          tma_load_3d(a_tile(stage), &maps.a[j], full(stage), c0, mt * kBM, b);
          tma_load_2d(b_tile(stage), &maps.w, full(stage), j * C + c0, nt * S::kBN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 frames each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[NB][64];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int nt = tile % n_tiles, mt = (tile / n_tiles) % m_tiles;
      const int b = tile / (n_tiles * m_tiles);
      int last = stage;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full(stage), phase);
        const uint32_t a = a_tile(stage) + wg * 64 * 128;  // this warpgroup's 64 rows
        const uint32_t bt = b_tile(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {  // 32 bytes per k16 step
#pragma unroll
          for (int h = 0; h < NB; ++h)
            wgmma_m64n128k16(acc[h], smem_desc(a + 32 * kk),
                             smem_desc(bt + h * 128 * 128 + 32 * kk), ks > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's wgmma has read its stage
        if (ks > 0 && lane == 0) mbar_arrive(empty(last));
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty(last));

      // Fragment: acc[h][4j + 2i + e] is frame row 16*warp + lane/4 + 8i of
      // the warpgroup's 64, channel 128h + 8j + 2(lane%4) + e of the tile.
      const int n0 = nt * S::kBN;
      const int q = lane & 3;
      const int t = mt * kBM + wg * 64 + warp * 16 + lane / 4 + (q & 1) * 8;
      bf16* yrow = y + ((size_t)b * T_out + t) * C + n0;
#pragma unroll
      for (int h = 0; h < NB; ++h) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {  // channel chunks 2jj and 2jj+1
          uint32_t w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // chunk c: row half c&1, column block 2jj + c/2
            const int j = 2 * jj + c / 2, i = c & 1;
            const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
                bias + n0 + 128 * h + 8 * j + 2 * q);
            w[c] = finish_pair(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1], bv, gelu);
          }
          const uint4 v = quad_transpose(w, lane);  // chunk q: row half q&1, block 2jj + q/2
          if (t < T_out)
            *reinterpret_cast<uint4*>(yrow + 128 * h + 8 * (2 * jj + q / 2)) = v;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 GEMM

constexpr int kFM = 64, kFN = 64, kFK = 16;

// The same GEMM in f32 on the CUDA cores, with w stacked [K*C, C]. Grid
// (ceil(T_out / 64), C / 64, B); thread (ty, tx) owns rows 4ty..4ty+3 and
// columns 4tx..4tx+3 of the tile.
__global__ void __launch_bounds__(kThreads)
conv_layer_f32(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y, int T_in,
               int T_out, int C, int Kdim, int gelu) {
  __shared__ float As[kFK][kFM + 4];  // transposed: As[k][row]
  __shared__ float Bs[kFK][kFN];
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const float* xb = x + (size_t)b * T_in * C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Kdim; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kFK, kk = c % kFK;
      const int t = t0 + r;
      As[kk][r] = t < T_out ? xb[(size_t)2 * t * C + k0 + kk] : 0.f;
      const int br = c / kFN, bn = c % kFN;
      Bs[br][bn] = w[(size_t)(k0 + br) * C + n0 + bn];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      y[((size_t)b * T_out + t) * C + n] = epilogue<float>(acc[i][j], bias[n], gelu);
    }
  }
}

// ------------------------------------------------------------ LN then GELU

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In place over `rows` frames of C values: LN with two-pass f32 moments,
// rounded, then GELU, rounded. One warp per frame.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_gelu(T* __restrict__ y, const float* __restrict__ scale,
        const float* __restrict__ shift, long long rows, int C, float eps) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  T* p = y + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_float(p[c]);
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_float(p[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float z = round_to((to_float(p[c]) - mean) * rstd * scale[c] + shift[c], T{});
    store(p + c, round_to(gelu_of(z, T{}), T{}));
  }
}

// ---------------------------------------------------------------- host side

int tail_length(int T, int K) { return (T - K) / 2 + 1; }

// A 128-byte-swizzled bf16 tensor map of `rank` dims (innermost first).
bool encode_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                                const_cast<void*>(base), dims, strides, box, ones,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
cudaError_t launch_wgmma(const TailMaps& maps, const bf16* bias, bf16* y, int B, int T_out,
                         int C, int K, bool gelu, cudaStream_t stream) {
  using S = Tile<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_layer_wgmma<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)B * ((T_out + kBM - 1) / kBM) * (C / S::kBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv_layer_wgmma<NB><<<grid, kGemmThreads, S::kSmem, stream>>>(maps, bias, y, B, T_out, C,
                                                                 K, gelu);
  return cudaGetLastError();
}

// One layer in bf16: x [B, T_in, C], w [C_out, K*C_in] (K-major).
cudaError_t launch_layer(const bf16* x, const bf16* w, const bf16* bias, bf16* y, int B,
                         int T_in, int T_out, int C, int K, bool gelu, cudaStream_t stream) {
  const int nb = C % 256 == 0 ? 2 : 1;
  TailMaps maps;
  const cuuint64_t a_dims[3] = {(cuuint64_t)C, (cuuint64_t)T_out, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)4 * C, (cuuint64_t)2 * T_in * C};
  const cuuint32_t a_box[3] = {kBK, kBM, 1};
  for (int j = 0; j < K; ++j)
    if (!encode_map(&maps.a[j], x + (size_t)j * C, 3, a_dims, a_strides, a_box))
      return cudaErrorInvalidValue;
  const cuuint64_t w_dims[2] = {(cuuint64_t)K * C, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)2 * K * C};
  const cuuint32_t w_box[2] = {kBK, (cuuint32_t)(128 * nb)};
  if (!encode_map(&maps.w, w, 2, w_dims, w_strides, w_box)) return cudaErrorInvalidValue;
  return nb == 2 ? launch_wgmma<2>(maps, bias, y, B, T_out, C, K, gelu, stream)
                 : launch_wgmma<1>(maps, bias, y, B, T_out, C, K, gelu, stream);
}

// One layer in f32: w [K*C_in, C_out].
cudaError_t launch_layer(const float* x, const float* w, const float* bias, float* y, int B,
                         int T_in, int T_out, int C, int K, bool gelu, cudaStream_t stream) {
  const dim3 grid((T_out + kFM - 1) / kFM, C / kFN, B);
  conv_layer_f32<<<grid, kThreads, 0, stream>>>(x, w, bias, y, T_in, T_out, C, K * C, gelu);
  return cudaGetLastError();
}

// Layer i reads the previous output and writes the next: x1 -> A -> B ->
// A -> B -> A -> out, where A holds B*T2*C values and B holds B*T3*C.
template <typename T>
int conv_tail(const T* x1, const T* w, const T* bias, const float* ln_scale,
              const float* ln_shift, T* scratch, T* out, int B, int T1, int C,
              int has_ln, float eps, cudaStream_t stream) {
  if (B < 1 || B > 65535 || C < 128 || C % 128 != 0)
    return (int)cudaErrorInvalidValue;
  int len[kLayers + 1];
  len[0] = T1;
  for (int i = 0; i < kLayers; ++i) len[i + 1] = tail_length(len[i], kTaps[i]);
  if (len[kLayers] < 1) return (int)cudaErrorInvalidValue;
  T* bufs[2] = {scratch, scratch + (size_t)B * len[1] * C};
  const T* src = x1;
  size_t w_off = 0;
  for (int i = 0; i < kLayers; ++i) {
    T* dst = i == kLayers - 1 ? out : bufs[i % 2];
    cudaError_t err = launch_layer(src, w + w_off, bias + (size_t)i * C, dst, B, len[i],
                                   len[i + 1], C, kTaps[i], !has_ln, stream);
    if (err != cudaSuccess) return (int)err;
    if (has_ln) {
      const long long rows = (long long)B * len[i + 1];
      const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
      ln_gelu<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
          dst, ln_scale + (size_t)i * C, ln_shift + (size_t)i * C, rows, C, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    w_off += (size_t)kTaps[i] * C * C;
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

// Conv layers 1-6 over x1 [B, T1, C] into out [B, T7, C] on `stream`.
// w: the six layers' weights one after the other, each [C_out, K*C_in]
// (row c_out, column k*C + c_in) in bf16 and [K*C_in, C_out] in f32; bias
// [6, C] in the working type; ln_scale, ln_shift [6, C] f32, read only when
// has_ln; scratch: B*(T2+T3)*C values of the working type. All contiguous
// and 16-byte aligned; C a multiple of 128. Returns the CUDA error of the
// launches (0 on success); asynchronous.
int conv_tail_bf16(const void* x1, const void* w, const void* bias,
                   const float* ln_scale, const float* ln_shift, void* scratch,
                   void* out, int B, int T1, int C, int has_ln, float eps,
                   void* stream) {
  return conv_tail<bf16>(static_cast<const bf16*>(x1),
                         static_cast<const bf16*>(w),
                         static_cast<const bf16*>(bias), ln_scale, ln_shift,
                         static_cast<bf16*>(scratch), static_cast<bf16*>(out),
                         B, T1, C, has_ln, eps, (cudaStream_t)stream);
}

int conv_tail_f32(const float* x1, const float* w, const float* bias,
                  const float* ln_scale, const float* ln_shift, float* scratch,
                  float* out, int B, int T1, int C, int has_ln, float eps,
                  void* stream) {
  return conv_tail<float>(x1, w, bias, ln_scale, ln_shift, scratch, out, B, T1,
                          C, has_ln, eps, (cudaStream_t)stream);
}

const char* conv_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
