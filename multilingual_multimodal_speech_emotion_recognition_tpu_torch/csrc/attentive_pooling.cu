// Masked attentive-statistics pooling in one streaming pass over time.
//
// Replaces the TPU kernel attentive_stats_pooling_pallas
// (multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:208,
// body _pool_kernel :161). Per batch row, all in f32: frame score
// sc = tanh(x . W1 + b1) . w2 + b2, -1e30 on masked frames; an online
// softmax over time with running max m (from -1e30), e = exp(sc - m) * mask,
// normaliser l; s1 = sum e x and s2 = sum e x^2 rescaled as m moves; then
// mean = s1 / max(l, 1e-30), std = sqrt(max(s2 / l - mean^2, 0) + 1e-6).
// Output [B, 2D] = mean | std in the type of x.
//
// Bound on an H100: reading x. At the audio pooling site (B=128, S=199,
// D=768, bf16) x is 39 MB, 12 us at 3.35 TB/s; the score MLP's 5.0 GFLOP
// (bf16 inputs, tensor-core work) would take 5 us at 989 TFLOP/s.
//
// bf16 route (bf16 x and bf16 W1; pool_wgmma). The sequence is cut into
// tiles of 64 rows (frames of one batch row, or several short rows packed
// together); a batch row's tiles go to a cluster of up to 8 blocks, each
// taking a few tiles in turn, so that a few rows still spread over many
// SMs (ops/attentive_pooling.plan picks tiles, rows per tile, cluster size
// and the W1 ring). A block is one consumer warpgroup and one producer
// warp:
// - The producer brings a tile of x by TMA as bf16, one 64-column panel
//   per mbarrier (panels past D and frames past S zero-filled), and
//   streams W1 in chunks of up to 128 rows through an mbarrier ring that
//   runs ahead across the block's tiles. Copies overlap the products.
// - The score MLP runs on the tensor cores: wgmma m64nNk16 (N = H, at
//   least 64) with x as the K-major operand and W1 [D, H] read MN-major,
//   bf16 products summed in f32 (exact products, so only the order of the
//   sum differs from the plain version), each chunk's products in flight
//   while the next chunk's are issued.
// - tanh(acc + b1) . w2 is applied to the accumulator fragments in
//   registers (tanh.approx.f32) and summed over H in each quad of lanes:
//   the scores never leave the SM. One warp per row does the tile's online
//   softmax; the statistics pass reads the bf16 tile on the CUDA cores in
//   f32, one owner thread per 16-byte unit of 8 channels.
// - A block keeps (m, l, s1, s2) for its frames. In a cluster each block
//   pushes its sums of the channels block k finalizes into block k's
//   shared memory (distributed shared memory); after one cluster barrier
//   block k combines them in rank order and writes its channels.
// Every sum runs in a fixed order with no atomics, so repeats are bitwise
// equal. What bounds a block is its SM's copy rate (about 50 GB/s into one
// SM, PERF.md): each tile brings 96 KB of x and all of W1 (192 KB at
// H=128, D=768), and the phases of a tile run one after another.
//
// f32 route (f32 x, or bf16 x with f32 W1; attentive_pool): one block per
// batch row walks S in tiles of 32 frames kept in shared memory as f32; the
// MLP runs on the CUDA cores in f32 with each thread owning one hidden
// unit; the H hidden units of a frame are summed warp by warp and then over
// warps in a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kSt = 32;  // frames per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kSt * D + 2 * (size_t)D + kSt * kWarps + 2 * kSt);
}

// Grid (B). x: [B, S, D]; mask: [B, S] f32; w1: [D, H]; b1, w2: [H]; b2: [1];
// out: [B, 2D]. H is 32, 64, 128 or 256; D a multiple of 4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attentive_pool(const T* __restrict__ x, const float* __restrict__ mask,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               T* __restrict__ out, int S, int D, int H) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kSt][D]
  float* s1 = xs + kSt * D;                     // [D]  sum e x
  float* s2 = s1 + D;                           // [D]  sum e x^2
  float* part = s2 + D;                         // [kSt][H / 32] score partials
  float* sc = part + kSt * kWarps;              // [kSt] masked scores
  float* mk = sc + kSt;                         // [kSt] mask values

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const int groups = kThreads / H;    // frames are split over thread groups
  const int j = tid % H, g = tid / H;
  const int rows = kSt / groups;      // frames g, g + groups, ... of a thread
  const int wpg = H / 32, wi = j / 32;
  const T* xb = x + (size_t)b * S * D;
  const float* mb = mask + (size_t)b * S;
  const float b1j = b1[j], w2j = w2[j], b2v = b2[0];

  for (int d = tid; d < D; d += kThreads) s1[d] = s2[d] = 0.f;
  float m = kNegBig, l = 0.f;

  for (int s0 = 0; s0 < S; s0 += kSt) {
    __syncthreads();  // the last tile's xs, sc and mk are read
    for (int i = tid; i < kSt * D; i += kThreads) {
      const int r = i / D, s = s0 + r;
      xs[i] = s < S ? to_float(xb[(size_t)s * D + (i - r * D)]) : 0.f;
    }
    __syncthreads();

    float acc[kSt];
#pragma unroll
    for (int i = 0; i < kSt; ++i) acc[i] = 0.f;
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float wa = w1[(size_t)(4 * d4) * H + j];
      const float wb = w1[(size_t)(4 * d4 + 1) * H + j];
      const float wc = w1[(size_t)(4 * d4 + 2) * H + j];
      const float wd = w1[(size_t)(4 * d4 + 3) * H + j];
#pragma unroll
      for (int i = 0; i < kSt; ++i) {
        if (i < rows) {
          const float4 xv = reinterpret_cast<const float4*>(xs + (g + groups * i) * D)[d4];
          acc[i] = fmaf(xv.x, wa, acc[i]);
          acc[i] = fmaf(xv.y, wb, acc[i]);
          acc[i] = fmaf(xv.z, wc, acc[i]);
          acc[i] = fmaf(xv.w, wd, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSt; ++i) {
      if (i < rows) {
        const float hv = warp_sum(tanhf(acc[i] + b1j) * w2j);
        if (lane == 0) part[(g + groups * i) * kWarps + wi] = hv;
      }
    }
    __syncthreads();
    if (tid < kSt) {
      float dot = 0.f;
      for (int w = 0; w < wpg; ++w) dot += part[tid * kWarps + w];
      const int s = s0 + tid;
      const float mv = s < S ? mb[s] : 0.f;
      mk[tid] = mv;
      sc[tid] = mv == 0.f ? kNegBig : dot + b2v;
    }
    __syncthreads();

    // every thread computes the same m, e and l, in the same order
    float tmax = kNegBig;
    for (int r = 0; r < kSt; ++r) tmax = fmaxf(tmax, sc[r]);
    const float m_new = fmaxf(m, tmax);
    const float rescale = expf(m - m_new);
    float e[kSt];
    float esum = 0.f;
#pragma unroll
    for (int r = 0; r < kSt; ++r) {
      e[r] = expf(sc[r] - m_new) * mk[r];
      esum += e[r];
    }
    l = l * rescale + esum;
    m = m_new;
    for (int d = tid; d < D; d += kThreads) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int r = 0; r < kSt; ++r) {
        const float xv = xs[r * D + d];
        a1 = fmaf(e[r], xv, a1);
        a2 = fmaf(e[r], xv * xv, a2);
      }
      s1[d] = s1[d] * rescale + a1;
      s2[d] = s2[d] * rescale + a2;
    }
  }

  const float lf = fmaxf(l, 1e-30f);
  T* ob = out + (size_t)b * 2 * D;
  for (int d = tid; d < D; d += kThreads) {
    const float mean = s1[d] / lf;
    const float ex2 = s2[d] / lf;
    store(ob + d, mean);
    store(ob + D + d, sqrtf(fmaxf(ex2 - mean * mean, 0.f) + 1e-6f));
  }
}

template <typename T>
int launch(const T* x, const float* mask, const float* w1, const float* b1,
           const float* w2, const float* b2, T* out, int B, int S, int D,
           int H, cudaStream_t stream) {
  if (B < 1 || S < 1 || D < 4 || D % 4 != 0 ||
      !(H == 32 || H == 64 || H == 128 || H == 256))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attentive_pool<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attentive_pool<T><<<B, kThreads, smem, stream>>>(x, mask, w1, b1, w2, b2, out,
                                                   S, D, H);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16: TMA + wgmma

constexpr int kTileRows = 64;        // rows of a tile: one wgmma M
constexpr int kWgThreads = 128;      // the consumer warpgroup
constexpr int kConsumerWarps = kWgThreads / 32;
constexpr int kBlockThreads = kWgThreads + 32;  // and one producer warp
constexpr int kPanelBytes = kTileRows * 128;  // 64 rows of 64 bf16
// 8-channel units a consumer thread owns at most (D <= 1536)
constexpr int kMaxUnits = (1536 / 8 + kWgThreads - 1) / kWgThreads;
constexpr int kMaxCluster = 8;

// The layout pool_wgmma carves from dynamic shared memory; plan() in
// ops/attentive_pooling.py mirrors wgmma_smem_bytes.
struct Layout {
  int panels;      // 64-column panels of x (D rounded up to 64)
  int nb;          // 64-column panels of W1 (H rounded up to 64)
  int chunk;       // W1 rows per ring slot
  int depth;       // ring slots
  int cluster;     // blocks that combine one row
  __host__ __device__ int slot_bytes() const { return nb * chunk * 128; }
  __host__ __device__ int x_off() const { return 0; }
  __host__ __device__ int ring_off() const { return panels * kPanelBytes; }
  __host__ __device__ int bar_off() const { return ring_off() + depth * slot_bytes(); }
  // x panels' barriers, the ring's full and empty ones, x's free one (to 16 bytes)
  __host__ __device__ int vec_off() const {
    return bar_off() + (8 * (panels + 2 * depth + 1) + 15) / 16 * 16;
  }
  // b1, w2 [64 nb]; mask, score/weight, running max, normaliser, rescale [64]
  __host__ __device__ int rx_off() const { return vec_off() + 4 * (2 * 64 * nb + 5 * kTileRows); }
  // the combine's receive buffer: each peer's sums of this block's units
  // (8 channels each, ceil(D / 8 / cluster) of them) and its (m, l)
  __host__ __device__ int rx_floats() const {
    const int per = (panels * 8 + cluster - 1) / cluster;
    return cluster == 1 ? 0 : 16 * cluster * per + 2 * cluster;
  }
  __host__ __device__ int bytes() const { return rx_off() + 4 * rx_floats(); }
};

size_t wgmma_smem_bytes(const Layout& lay) { return 1024 + (size_t)lay.bytes(); }

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

// Descriptors of 128-byte-swizzled panels (8-row atoms of 1024 bytes, as
// TMA's SWIZZLE_128B writes them). K-major (x: the reduction runs along a
// row): the next 8 rows are 1024 bytes on. MN-major (W1: the output
// dimension runs along a row): the next 8 rows of k are 1024 bytes on, the
// next 64 columns of H `lbo` bytes on.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
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
// The consumer warpgroup's own barrier (the producer warp is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads) : "memory");
}

// d (64 x 64 f32) += a . b; a K-major, b MN-major.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));  // scale-d: accumulate
}

// d (64 x 128 f32) += a . b; a K-major, b MN-major.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));  // scale-d: accumulate
}

// The accumulator of a 64 x (64 NB) product over the warpgroup: kHalves
// wgmma outputs of kW registers (n64 for NB = 1, n128 otherwise). Element
// 4j + 2i + e of half h is row 16 warp + lane/4 + 8i, column
// 2 kW h + 8j + 2 (lane % 4) + e.
// tanh on the special-function unit (tanh.approx.f32: relative error about
// 2^-11); PERF.md records the pooled outputs' error against the plain
// version with it.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NB>
struct Acc {
  static constexpr int kW = NB == 1 ? 32 : 64;
  static constexpr int kHalves = NB == 4 ? 2 : 1;
  float v[kHalves][kW];
};

// One 16-row k-step, accumulated onto acc (zeroed before a tile's first):
// a is x's panel address at this step's 16 columns, b the W1 slot's
// address at this step's 16 rows, `pstride` the bytes between the slot's
// 64-column panels.
template <int NB>
__device__ __forceinline__ void mma_step(Acc<NB>& acc, uint32_t a, uint32_t b, uint32_t pstride) {
#pragma unroll
  for (int h = 0; h < Acc<NB>::kHalves; ++h) {
    if constexpr (NB == 1)
      wgmma_m64n64(acc.v[h], desc_k_major(a), desc_mn_major(b, pstride));
    else
      wgmma_m64n128(acc.v[h], desc_k_major(a), desc_mn_major(b + 2 * h * pstride, pstride));
  }
}

__device__ __forceinline__ float load_vec(const void* p, int i, int vec_bf16) {
  return vec_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                  : static_cast<const float*>(p)[i];
}

// mean | std of one channel pair from its weighted sums, to bf16.
__device__ __forceinline__ void finish_pair(bf16* ob, int D, int p, float s1x, float s1y,
                                            float s2x, float s2y, float l) {
  const float lf = fmaxf(l, 1e-30f);
  const float mx = s1x / lf, my = s1y / lf;
  const float vx = s2x / lf - mx * mx, vy = s2y / lf - my * my;
  *reinterpret_cast<__nv_bfloat162*>(ob + 2 * p) = __floats2bfloat162_rn(mx, my);
  *reinterpret_cast<__nv_bfloat162*>(ob + D + 2 * p) = __floats2bfloat162_rn(
      sqrtf(fmaxf(vx, 0.f) + 1e-6f), sqrtf(fmaxf(vy, 0.f) + 1e-6f));
}

// pool_wgmma's arguments besides the tensor maps. stamps: null, or
// kStamps values a block that a timed breakdown reads
// (scripts/torch_pool_breakdown.py): the global timer (ns) once the block
// is set up and when it ends, the SM clock at the same two points and at
// each phase boundary of the first tile, and the SM it ran on.
struct PoolArgs {
  const float* mask;
  const void* b1;
  const void* w2;
  const void* b2;
  int vec_bf16;
  bf16* out;
  unsigned long long* stamps;
  int B, S, D, H, seg, rows, cluster, tiles, chunk, depth;
};
constexpr int kStamps = 10;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(id));
  return id;
}

// Grid (cluster * ceil(B / rows)), clusters of `cluster` blocks of 160
// threads: a consumer warpgroup, then a producer warp. A tile is `rows` batch rows x `seg` frames (rows * seg <= 64,
// tile row r = batch row r / seg, frame r % seg); a row of the sequence has
// nt = ceil(S / seg) tiles; block `rank` of a cluster takes the row group's
// tiles rank * tiles .. + tiles - 1. rows > 1 only when nt == 1 (then
// cluster == 1). xmap: x as {D, S, B} with box {64, seg, rows}; wmap: W1 as
// {H, D} with box {64, chunk}; both SWIZZLE_128B, zero past the edges.
// kSteps = chunk / 16, the k-steps of a ring slot, fixed at compile time so
// that the products of a slot issue back to back.
template <int NB, int kSteps>
__global__ void __launch_bounds__(kBlockThreads, 1)
pool_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           const PoolArgs a) {
  const float* __restrict__ mask = a.mask;
  bf16* __restrict__ out = a.out;
  const int B = a.B, S = a.S, D = a.D, H = a.H, seg = a.seg, rows = a.rows;
  const int cluster = a.cluster, tiles = a.tiles, chunk = a.chunk, depth = a.depth;
  unsigned long long* stamp = a.stamps && threadIdx.x == 0 ? a.stamps + blockIdx.x * kStamps
                                                           : nullptr;
  const Layout lay{(D + 63) / 64, NB, chunk, depth, cluster};
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t xs = smem_u32(base + lay.x_off());
  const uint32_t ring = smem_u32(base + lay.ring_off());
  const uint32_t bars = smem_u32(base + lay.bar_off());
  float* b1s = reinterpret_cast<float*>(base + lay.vec_off());  // [64 NB]
  float* w2s = b1s + 64 * NB;                                  // [64 NB]
  float* mk = w2s + 64 * NB;     // [64] mask of each tile row, 0 where no frame
  float* sc = mk + kTileRows;    // [64] score, then weight e
  float* m_run = sc + kTileRows;  // [rows] running max
  float* l_run = m_run + kTileRows;  // [rows] normaliser
  float* resc = l_run + kTileRows;   // [rows] this tile's rescale
  float* rx = reinterpret_cast<float*>(base + lay.rx_off());
  auto xbar = [&](int p) { return bars + 8 * p; };
  auto full = [&](int s) { return bars + 8 * (lay.panels + s); };
  auto empty = [&](int s) { return bars + 8 * (lay.panels + depth + s); };
  const uint32_t xfree = bars + 8 * (lay.panels + 2 * depth);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % cluster, group = blockIdx.x / cluster;
  const int b0 = group * rows;
  const int nt = (S + seg - 1) / seg;
  const int first = rank * tiles;
  const int my_tiles = max(0, min(tiles, nt - first));
  const int nk = lay.panels * 64 / chunk;  // W1 chunks per tile
  const uint32_t pstride = chunk * 128;
  const int tile_rows = rows * seg;

  if (tid == 0) {
    for (int p = 0; p < lay.panels; ++p) mbar_init(xbar(p), 1);
    for (int s = 0; s < depth; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);  // lane 0 of each consumer warp
    }
    mbar_init(xfree, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int n = tid; n < 64 * NB; n += kBlockThreads) {
    b1s[n] = n < H ? load_vec(a.b1, n, a.vec_bf16) : 0.f;
    w2s[n] = n < H ? load_vec(a.w2, n, a.vec_bf16) : 0.f;
  }
  if (tid < kTileRows) {
    m_run[tid] = kNegBig;
    l_run[tid] = 0.f;
  }
  const float b2v = load_vec(a.b2, 0, a.vec_bf16);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp: one thread brings each tile's x panels, then its
    // W1 chunks through the ring as slots come free
    if (lane == 0) {
      auto issue_w1 = [&](int q) {  // W1 chunk q (rows (q % nk) chunk ..) once its slot is free
        const int slot = q % depth;
        mbar_wait(empty(slot), ((q / depth) & 1) ^ 1);
        mbar_expect_tx(full(slot), lay.slot_bytes());
        for (int n = 0; n < NB; ++n)
          tma_load_2d(ring + slot * lay.slot_bytes() + n * pstride, &wmap, full(slot), 64 * n,
                      (q % nk) * chunk);
      };
      for (int j = 0; j < my_tiles; ++j) {
        if (j > 0) mbar_wait(xfree, (j - 1) & 1);  // the last tile's x is read
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // each x panel, then the W1 chunks it feeds while their slots are
        // fresh, so that the first products can start early
        int c = 0;
        for (int p = 0; p < lay.panels; ++p) {
          mbar_expect_tx(xbar(p), 128 * tile_rows);
          tma_load_3d(xs + p * kPanelBytes, &xmap, xbar(p), 64 * p, (first + j) * seg, b0);
          for (; c < nk && c * chunk < 64 * (p + 1) && j * nk + c < depth; ++c)
            issue_w1(j * nk + c);
        }
        for (; c < nk; ++c) issue_w1(j * nk + c);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  if (stamp) {
    stamp[0] = global_ns();
    stamp[1] = clock64();
  }
  auto finish = [&]() {  // the last stamps, before the block returns
    if (stamp) {
      stamp[7] = clock64();
      stamp[8] = global_ns();
      stamp[9] = sm_id();
    }
  };

  const bool direct = cluster == 1 && nt == 1;  // one tile holds whole rows
  const int units = D / 8;  // 8-channel units of a row
  float s1[kMaxUnits][8] = {}, s2[kMaxUnits][8] = {};

  for (int j = 0; j < my_tiles; ++j) {
    const int s0 = (first + j) * seg;
    if (tid < kTileRows) {
      const int rr = tid / seg, s = s0 + tid % seg, b = b0 + rr;
      mk[tid] = (rr < rows && b < B && s < S) ? mask[(size_t)b * S + s] : 0.f;
    }

    // scores: x [64, Dp] . W1 [Dp, 64 NB] on the tensor cores, each chunk's
    // products in flight while the next chunk's are issued; a slot is
    // released once the products that read it have retired
    Acc<NB> acc;
#pragma unroll
    for (int h = 0; h < Acc<NB>::kHalves; ++h)
#pragma unroll
      for (int n = 0; n < Acc<NB>::kW; ++n) acc.v[h][n] = 0.f;
    for (int c = 0; c < nk; ++c) {
      const int q = j * nk + c, slot = q % depth;
      const int k0 = c * chunk;
      for (int p = k0 / 64; p <= (k0 + chunk - 1) / 64; ++p) mbar_wait(xbar(p), j & 1);
      mbar_wait(full(slot), (q / depth) & 1);
      if (stamp && q == 0) stamp[2] = clock64();  // x panel 0 and W1 chunk 0 are in
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int col = k0 + 16 * st;
        mma_step<NB>(acc, xs + (col / 64) * kPanelBytes + ((col % 64) / 16) * 32,
                     ring + slot * lay.slot_bytes() + st * 16 * 128, pstride);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(empty((q - 1) % depth));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty((j * nk + nk - 1) % depth));

    if (stamp && j == 0) stamp[3] = clock64();
    // sc = tanh(acc + b1) . w2, over this thread's columns in four
    // independent sums, then over the quad of lanes that shares a row
    const int qd = lane % 4;
    float part[2][4] = {};
#pragma unroll
    for (int h = 0; h < Acc<NB>::kHalves; ++h)
#pragma unroll
      for (int jj = 0; jj < Acc<NB>::kW / 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * Acc<NB>::kW * h + 8 * jj + 2 * qd + e;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            part[i][jj % 4] += tanh_approx(acc.v[h][4 * jj + 2 * i + e] + b1s[col]) * w2s[col];
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = (part[i][0] + part[i][1]) + (part[i][2] + part[i][3]);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (qd == 0) sc[16 * warp + lane / 4 + 8 * i] = v;
    }
    consumer_sync();

    // online softmax, one warp per packed row: the tile's max, the rescale
    // of the running sums and the weights e = exp(sc - m) * mask
    for (int rr = warp; rr < rows; rr += kConsumerWarps) {
      float v[2], mv[2];
      float tmax = kNegBig;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int f = lane + 32 * k;
        mv[k] = f < seg ? mk[rr * seg + f] : 0.f;
        v[k] = mv[k] != 0.f ? sc[rr * seg + f] + b2v : kNegBig;
        tmax = fmaxf(tmax, v[k]);
      }
      tmax = warp_max(tmax);
      const float m_old = m_run[rr], m_new = fmaxf(m_old, tmax);
      float esum = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int f = lane + 32 * k;
        const float e = expf(v[k] - m_new) * mv[k];
        if (f < seg) sc[rr * seg + f] = e;
        esum += e;
      }
      esum = warp_sum(esum);
      if (lane == 0) {
        const float r = expf(m_old - m_new);
        resc[rr] = r;
        l_run[rr] = l_run[rr] * r + esum;
        m_run[rr] = m_new;
      }
    }
    consumer_sync();
    if (stamp && j == 0) stamp[4] = clock64();

    // statistics: sum e x and e x^2 over the tile's frames, one owner
    // thread per unit of 8 channels (one 16-byte unit of a swizzled panel
    // row), four frames' loads in flight at a time
    const unsigned char* xt = base + lay.x_off();
    for (int rr = 0; rr < rows; ++rr) {
      const float r = resc[rr];
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        const int u = tid + kWgThreads * i;
        if (u >= units) break;
        const unsigned char* xu = xt + (u / 8) * kPanelBytes;
        float a1[8] = {}, a2[8] = {};
#pragma unroll 4
        for (int f = 0; f < seg; ++f) {
          const int row = rr * seg + f;
          const float e = sc[row];
          const uint4 raw = *reinterpret_cast<const uint4*>(xu + row * 128 +
                                                            (((u % 8) ^ (row % 8)) * 16));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
            const float ex = e * xv.x, ey = e * xv.y;
            a1[2 * k] += ex;
            a1[2 * k + 1] += ey;
            a2[2 * k] = fmaf(ex, xv.x, a2[2 * k]);
            a2[2 * k + 1] = fmaf(ey, xv.y, a2[2 * k + 1]);
          }
        }
        if (direct) {
          const int b = b0 + rr;
          if (b < B)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              finish_pair(out + (size_t)b * 2 * D, D, 4 * u + k, a1[2 * k], a1[2 * k + 1],
                          a2[2 * k], a2[2 * k + 1], l_run[rr]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            s1[i][k] = fmaf(s1[i][k], r, a1[k]);
            s2[i][k] = fmaf(s2[i][k], r, a2[k]);
          }
        }
      }
    }
    consumer_sync();  // x, sc and mk are read: the next tile may refill them
    if (tid == 0 && j + 1 < my_tiles) mbar_arrive(xfree);
    if (stamp && j == 0) stamp[5] = clock64();
  }
  if (stamp) stamp[6] = clock64();
  if (direct) {
    finish();
    return;
  }

  // One batch row per cluster from here (rows == 1).
  if (cluster == 1) {
    if (b0 < B)
#pragma unroll
      for (int i = 0; i < kMaxUnits; ++i) {
        const int u = tid + kWgThreads * i;
        if (u < units)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            finish_pair(out + (size_t)b0 * 2 * D, D, 4 * u + k, s1[i][2 * k], s1[i][2 * k + 1],
                        s2[i][2 * k], s2[i][2 * k + 1], l_run[0]);
      }
    finish();
    return;
  }
  // Each block pushes its sums of the units block k finalizes, and its
  // (m, l), into block k's receive buffer (distributed shared memory); one
  // cluster barrier; then each block combines its slice from its own
  // shared memory, peers in rank order. rx: [cluster][s1 | s2][8 per],
  // then [cluster][m, l].
  cg::cluster_group cl = cg::this_cluster();
  const int per = (units + cluster - 1) / cluster;  // units a block finalizes
  float* rx_ml = rx + 16 * cluster * per;
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) {
    const int u = tid + kWgThreads * i;
    if (u < units) {
      const int owner = u / per;
      float* dst = cl.map_shared_rank(rx, owner) + 16 * rank * per + 8 * (u - owner * per);
      float4* d1 = reinterpret_cast<float4*>(dst);
      float4* d2 = reinterpret_cast<float4*>(dst + 8 * per);
      d1[0] = make_float4(s1[i][0], s1[i][1], s1[i][2], s1[i][3]);
      d1[1] = make_float4(s1[i][4], s1[i][5], s1[i][6], s1[i][7]);
      d2[0] = make_float4(s2[i][0], s2[i][1], s2[i][2], s2[i][3]);
      d2[1] = make_float4(s2[i][4], s2[i][5], s2[i][6], s2[i][7]);
    }
  }
  if (tid < cluster) {
    float* d = cl.map_shared_rank(rx_ml, tid) + 2 * rank;
    d[0] = m_run[0];
    d[1] = l_run[0];
  }
  cl.sync();  // every push has landed; nothing reads a peer's memory after it
  float peer_f[kMaxCluster];
  float M = kNegBig, L = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    if (k < cluster) M = fmaxf(M, rx_ml[2 * k]);
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) {
    peer_f[k] = k < cluster ? expf(rx_ml[2 * k] - M) : 0.f;  // rescale of peer k's sums
    if (k < cluster) L = fmaf(peer_f[k], rx_ml[2 * k + 1], L);
  }
  if (b0 < B)
    for (int v = tid; v < per && rank * per + v < units; v += kWgThreads) {
      float a1[8] = {}, a2[8] = {};
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k >= cluster) break;
        const float* src = rx + 16 * k * per + 8 * v;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          a1[c] = fmaf(peer_f[k], src[c], a1[c]);
          a2[c] = fmaf(peer_f[k], src[8 * per + c], a2[c]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        finish_pair(out + (size_t)b0 * 2 * D, D, 4 * (rank * per + v) + k, a1[2 * k],
                    a1[2 * k + 1], a2[2 * k], a2[2 * k + 1], L);
    }
  finish();
}

// A 128-byte-swizzled bf16 tensor map of `rank` dims (innermost first),
// zero-filled out of bounds.
bool encode_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                                const_cast<void*>(base), dims, strides, box, ones,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int kSteps>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const PoolArgs& a,
                         cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(Layout{(a.D + 63) / 64, NB, a.chunk, a.depth, a.cluster});
  cudaError_t err = cudaFuncSetAttribute(
      pool_wgmma<NB, kSteps>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.cluster * ((a.B + a.rows - 1) / a.rows)));
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pool_wgmma<NB, kSteps>, xmap, wmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance for H (64-column panels NB) and the ring's chunk.
template <int NB>
cudaError_t launch_nb(const CUtensorMap& xmap, const CUtensorMap& wmap, const PoolArgs& a,
                      cudaStream_t stream) {
  if constexpr (NB < 4)
    if (a.H > 64 * NB) return launch_nb<2 * NB>(xmap, wmap, a, stream);
  return a.chunk == 128  ? launch_wgmma<NB, 8>(xmap, wmap, a, stream)
         : a.chunk == 64 ? launch_wgmma<NB, 4>(xmap, wmap, a, stream)
         : a.chunk == 32 ? launch_wgmma<NB, 2>(xmap, wmap, a, stream)
                         : launch_wgmma<NB, 1>(xmap, wmap, a, stream);
}

}  // namespace

extern "C" {

// Pooling of x [B, S, D] with mask [B, S] f32 into out [B, 2D] (x's type),
// on `stream`. w1 [D, H], b1 [H], w2 [H], b2 [1], all f32. D a multiple of
// 4 whose tile fits shared memory (D <= 1536); H in {32, 64, 128, 256}. All
// contiguous. Returns the CUDA error of the launch (0 on success); the
// launch is asynchronous.
int attentive_pooling_bf16(const void* x, const float* mask, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           void* out, int B, int S, int D, int H, void* stream) {
  return launch<bf16>(static_cast<const bf16*>(x), mask, w1, b1, w2, b2,
                      static_cast<bf16*>(out), B, S, D, H, (cudaStream_t)stream);
}

int attentive_pooling_f32(const float* x, const float* mask, const float* w1,
                          const float* b1, const float* w2, const float* b2,
                          float* out, int B, int S, int D, int H, void* stream) {
  return launch<float>(x, mask, w1, b1, w2, b2, out, B, S, D, H,
                       (cudaStream_t)stream);
}

// The bf16 route: x [B, S, D] bf16 and w1 [D, H] bf16, both 16-byte
// aligned; b1 [H], w2 [H], b2 [1] bf16 when vec_bf16, else f32; mask [B, S]
// f32; out [B, 2D] bf16. D a multiple of 8, at most 1536; H in {32, 64,
// 128, 256}. seg, rows, cluster, tiles, chunk and depth as
// ops/attentive_pooling.plan gives them. stamps: null, or room for 10
// values a block of the timed breakdown. Returns the CUDA error of the
// launch (0 on success); asynchronous.
int attentive_pooling_wgmma(const void* x, const float* mask, const void* w1, const void* b1,
                            const void* w2, const void* b2, int vec_bf16, void* out,
                            unsigned long long* stamps, int B, int S, int D, int H, int seg,
                            int rows, int cluster, int tiles, int chunk, int depth,
                            void* stream) {
  const int nt = S >= 1 && seg >= 1 ? (S + seg - 1) / seg : 0;
  if (B < 1 || S < 1 || D < 8 || D % 8 != 0 || D > 1536 ||
      !(H == 32 || H == 64 || H == 128 || H == 256) || seg < 1 || seg > kTileRows ||
      (seg & (seg - 1)) != 0 || rows < 1 || rows * seg > kTileRows || (rows > 1 && nt != 1) ||
      cluster < 1 || cluster > kMaxCluster || tiles < 1 || (long long)cluster * tiles < nt ||
      !(chunk == 16 || chunk == 32 || chunk == 64 || chunk == 128) || depth < 1 ||
      (D + 63) / 64 * 64 % chunk != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint64_t x_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)2 * D, (cuuint64_t)2 * S * D};
  const cuuint32_t x_box[3] = {64, (cuuint32_t)seg, (cuuint32_t)rows};
  const cuuint64_t w_dims[2] = {(cuuint64_t)H, (cuuint64_t)D};
  const cuuint64_t w_strides[1] = {(cuuint64_t)2 * H};
  const cuuint32_t w_box[2] = {64, (cuuint32_t)chunk};
  if (!encode_map(&xmap, x, 3, x_dims, x_strides, x_box) ||
      !encode_map(&wmap, w1, 2, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  const PoolArgs a{mask, b1, w2, b2, vec_bf16, static_cast<bf16*>(out), stamps,
                   B, S, D, H, seg, rows, cluster, tiles, chunk, depth};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_nb<1>(xmap, wmap, a, st);
}

const char* attentive_pooling_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
