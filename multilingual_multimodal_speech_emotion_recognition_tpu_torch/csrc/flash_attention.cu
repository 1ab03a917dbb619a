// Masked multi-head attention, forward: online softmax over KV tiles.
//
// Replaces the TPU kernel flash_attention
// (multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:295,
// body _flash_kernel :259). Per head: s = (q . k) * scale with scale
// 1/sqrt(Dh) applied after the product; s = -1e30 where kv_mask == 0;
// running max m (from -1e30), normaliser l and accumulator o in f32, the
// probabilities kept to f32 accuracy through p . v; out = o / max(l, 1e-30),
// rounded once to the output type.
//
// Bound on an H100, bf16: q, k, v and out are read or written once. At the
// wav2vec2-base self-attention (B=128, S=199, D=768) that is 156.6 MB,
// 46.7 us at 3.35 TB/s. The products as this kernel issues them, all bf16
// on the tensor cores (q.k once, p.v twice: p's bf16 high and low parts),
// are 23.4 GFLOP, 23.6 us at 989 TFLOP/s. So bytes bound it at 46.7 us.
//
// bf16 design: one block per (batch * head, 64-query tile), one
// warpgroup; each warp owns 16 query rows. K, V and the key mask stream in
// 64-key tiles through a two-stage shared-memory ring filled by cp.async
// while the previous tile is in use; heads are read by stride from
// [B, S, H*Dh] (no transpose copy). Tiles are stored as 128-byte-swizzled
// panels of 64 columns, the layout wgmma reads without bank conflicts; Dh
// is zero-padded to 64 (or to 128 when Dh > 64), and zero columns change
// neither q.k nor the first Dh output columns. q.k is wgmma m64n64k16 from
// shared memory (bf16 in, f32 accumulate): bf16 x bf16 products are exact
// in f32, so only the order of the sum differs from the f32 plain version.
// The row max and sum stay in registers and reduce over the quad of lanes
// that shares a row. p.v runs on the tensor cores too without giving up
// f32 p: p = hi + lo with hi = bf16(p), lo = bf16(p - hi), and o
// accumulates hi.V + lo.V in f32 (residual about 2^-16 of p) by wgmma with
// p in registers and V read transposed (MN-major) from shared memory; l
// sums the f32 p. The output goes through shared memory to 16-byte stores.
// wgmma rather than mma.sync: a tile's products are then a dozen
// warpgroup-wide instructions with no fragment loads (ldmatrix) between
// them, and the hi/lo split costs one more instruction per 16 keys; an
// mma.sync form of the same design ran no faster on an H100, so the
// shorter one was kept. The products are not what bounds it at the
// flagship's sites: a block has
// only about four KV tiles at S=199, so the latency of each tile's loads
// and reductions sets its time. The key mask therefore rides in the ring
// (no device-memory read per key on the critical path) and four blocks
// share each SM (128 registers a thread) to hide the rest.
//
// f32 design: the same arithmetic on the CUDA cores, one block per
// (batch * head, 32-query tile), 8 threads per query row; K and V staged in
// shared memory as f32.
//
// Keys past Skv weigh exactly 0; a row whose keys are all masked therefore
// averages v over its Skv keys (the TPU kernel, which pads keys into the
// average, is undefined there too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxDh = 128;
constexpr float kNegBig = -1e30f;

// ------------------------------------------------------------- bf16: wgmma

constexpr int kTq = 64;  // query rows per block: one warpgroup, 16 per warp
constexpr int kTk = 64;  // keys per K/V tile
constexpr int kMmaThreads = 128;
constexpr int kPanelBytes = 64 * 128;  // 64 rows of 64 bf16, 128-byte swizzled
constexpr int kRing = 2;               // K/V/mask tiles in flight

// Q, then kRing stages of K and of V, each kPanels panels (Dp = 64
// kPanels), kRing mask tiles, and slack to align the panels to 1024 bytes.
size_t wgmma_smem_bytes(int panels) {
  return (size_t)(1 + 2 * kRing) * panels * kPanelBytes + kRing * kTk * sizeof(float) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async4(uint32_t smem, const void* gmem, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptors of 128-byte-swizzled panels (8-row atoms of 1024 bytes).
// K-major (Q, K: the reduction dimension runs along a row): the next 8 rows
// are 1024 bytes on. MN-major (V in p.V: the output dimension runs along a
// row): the next 8 keys are 1024 bytes on, the next 64 columns a panel on.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kPanelBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Splits the f32 pair (x, y) into bf16 pairs hi and lo with x ~ hi.x + lo.x.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Rows s0 .. s0+63 of one head (src points at [b, 0, h*Dh]; row stride D)
// into kPanels swizzled panels at `dst`: chunk c (16 bytes) of row r lands
// in panel c/8, at row r, chunk (c%8) ^ (r%8), as SWIZZLE_128B would put
// it. Rows past S and columns past Dh are 0. `aligned`: every row starts
// on 16 bytes, so cp.async can copy it; otherwise the copy is synchronous.
template <int kPanels>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src, int s0,
                                          int S, int D, int Dh, bool aligned, int tid) {
  constexpr int kChunks = 8 * kPanels;
#pragma unroll
  for (int i = tid; i < kTk * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks, s = s0 + r;
    const bool in = s < S && c * 8 < Dh;
    unsigned char* d = dst + (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16);
    const bf16* g = src + (size_t)s * D + c * 8;
    if (aligned) {
      cp_async16(smem_u32(d), in ? g : src, in);
    } else {
      bf16* e = reinterpret_cast<bf16*>(d);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = in ? g[k] : __float2bfloat16(0.f);
    }
  }
}

// o += p . V over one 16-key step, with p as its bf16 hi and lo parts.
template <int kPanels>
__device__ __forceinline__ void pv_step(float (&o)[32 * kPanels], const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], uint64_t v) {
  if constexpr (kPanels == 1) {
    wgmma_rs_m64n64(o, hi, v, 1);
    wgmma_rs_m64n64(o, lo, v, 1);
  } else {
    wgmma_rs_m64n128(o, hi, v, 1);
    wgmma_rs_m64n128(o, lo, v, 1);
  }
}

// Grid (ceil(Sq / 64), B * H), 128 threads: one warpgroup per 64 queries
// of one head. Dp = 64 kPanels >= Dh; the columns past Dh are zero.
template <int kPanels>
__global__ void __launch_bounds__(kMmaThreads, kPanels == 1 ? 4 : 2)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ mask,
                bf16* __restrict__ out, int Sq, int Skv, int H, int Dh, float scale,
                int aligned) {
  constexpr int kTileBytes = kPanels * kPanelBytes;
  constexpr int kO = 32 * kPanels;  // o's registers: 64 x Dp over 128 threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* Qs = base;                      // [kPanels][64 x 128 B]
  unsigned char* Ks = Qs + kTileBytes;           // [kRing][kPanels][64 x 128 B]
  unsigned char* Vs = Ks + kRing * kTileBytes;   // [kRing][kPanels][64 x 128 B]
  float* Ms = reinterpret_cast<float*>(Vs + kRing * kTileBytes);  // [kRing][64]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kTq, D = H * Dh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qd = lane % 4;  // this lane's column pair in an 8-column tile
  const bf16* qh = q + (size_t)b * Sq * D + h * Dh;
  const bf16* kh = k + (size_t)b * Skv * D + h * Dh;
  const bf16* vh = v + (size_t)b * Skv * D + h * Dh;
  const float* mrow = mask + (size_t)b * Skv;
  const int nkt = (Skv + kTk - 1) / kTk;

  // Tile t of K, V and the mask into ring slot t % kRing, as one copy group.
  auto load_kv = [&](int t) {
    const int slot = t % kRing, s0 = t * kTk;
    load_tile<kPanels>(Ks + slot * kTileBytes, kh, s0, Skv, D, Dh, aligned, tid);
    load_tile<kPanels>(Vs + slot * kTileBytes, vh, s0, Skv, D, Dh, aligned, tid);
    if (tid < kTk) {
      const bool in = s0 + tid < Skv;
      cp_async4(smem_u32(Ms + slot * kTk + tid), in ? mrow + s0 + tid : mrow, in);
    }
  };
  load_tile<kPanels>(Qs, qh, q0, Sq, D, Dh, aligned, tid);
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {  // the ring's first tiles (Q goes with tile 0)
    if (t < nkt) load_kv(t);
    cp_async_commit();
  }

  // Accumulator fragments: element 4j + 2i + e of s (or o) is row
  // 16 warp + lane/4 + 8i of the 64, column 8j + 2(lane%4) + e.
  float o[kO];
#pragma unroll
  for (int n = 0; n < kO; ++n) o[n] = 0.f;
  // Rows lane/4 and lane/4 + 8 of the warp's 16: running max, and this
  // lane's part of the row sum (the quad's parts are added at the end).
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  for (int it = 0; it < nkt; ++it) {
    const int buf = it % kRing, k0 = it * kTk;
    const int keys = Skv - k0;  // keys of this tile before Skv (>= 1)
    // Tile it + kRing - 1 streams in while this one is used; it refills
    // the slot that tile it - 1 left at the end of the last step.
    if (it + kRing - 1 < nkt) load_kv(it + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    // The copies were written through the generic proxy; wgmma reads
    // through the async one.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t Kt = smem_u32(Ks + buf * kTileBytes);
    const uint32_t Vt = smem_u32(Vs + buf * kTileBytes);

    // s = q . k over the tile's 64 keys: Dp/16 k-steps of 32 bytes each.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kPanels; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_m64n64(s, desc_k_major(smem_u32(Qs) + off), desc_k_major(Kt + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    // Scale after the product, -1e30 on masked keys, -inf past Skv.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * qd + e;
        const float keep = Ms[buf * kTk + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * j + 2 * i + e];
          x = c >= keys ? -INFINITY : (keep == 0.f ? kNegBig : x * scale);
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float rescale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      rescale[i] = exp2_approx((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= rescale[i];
    }
#pragma unroll
    for (int n = 0; n < kO; ++n) o[n] *= rescale[(n / 2) % 2];

    // p in f32 and its bf16 hi and lo parts for every 16-key step (the A
    // fragment of s's columns 16kk .. 16kk+15: rows g, g+8 x keys 2qd,
    // 2qd+8), all written before the products that read them are issued.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 < keys) {
        float p[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          p[n] = exp2_approx((s[8 * kk + n] - m[(n / 2) % 2]) * kLog2e);
          l[(n / 2) % 2] += p[n];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) split_pair(p[2 * r], p[2 * r + 1], hi[kk][r], lo[kk][r]);
      }
    }
    // o += hi . V + lo . V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk * 16 < keys) pv_step<kPanels>(o, hi[kk], lo[kk], desc_mn_major(Vt + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // the next step refills this buffer
  }

  // out = o / max(l, 1e-30), as o times the rounded reciprocal (within an
  // f32 ulp or two of the quotient, under the bf16 rounding that follows),
  // staged row-major in the K buffers (free now) for 16-byte stores.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = __frcp_rn(fmaxf(l[i], 1e-30f));
  }
  constexpr int ld = 64 * kPanels + 8;  // bf16 per staged row
  bf16* Os = reinterpret_cast<bf16*>(Ks) + warp * 16 * ld;
  const int g = lane / 4;
#pragma unroll
  for (int j = 0; j < kO / 4; ++j) {
    const int c = j * 8 + 2 * qd;
    *reinterpret_cast<__nv_bfloat162*>(Os + g * ld + c) =
        __floats2bfloat162_rn(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * ld + c) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
  }
  __syncwarp();
  const int chunks = Dh / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i % chunks, sq = q0 + warp * 16 + r;
    if (sq < Sq)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Sq + sq) * D + h * Dh + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * ld + c * 8);
  }
}

template <int kPanels>
cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                         bf16* out, int B, int Sq, int Skv, int H, int Dh, float scale,
                         cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(kPanels);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<kPanels>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const dim3 grid((Sq + kTq - 1) / kTq, B * H);
  flash_fwd_wgmma<kPanels><<<grid, kMmaThreads, smem, stream>>>(q, k, v, mask, out, Sq, Skv,
                                                                H, Dh, scale, aligned);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32: CUDA cores

constexpr int kBq = 32;       // query rows per block
constexpr int kBk = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kBq;  // 8 threads per query row
constexpr int kKeysPerThread = kBk / kRowThreads;

// Reduction over the 8 consecutive lanes that share a query row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kRowThreads / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kRowThreads / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)kBq * Dh + (size_t)kBk * (Dh + 4) +
                          (size_t)kBk * Dh + (size_t)kBq * (kBk + 1));
}

// Grid (ceil(Sq / kBq), B * H). q: [B, Sq, H*Dh]; k, v: [B, Skv, H*Dh];
// mask: [B, Skv] f32; out like q.
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ out, int Sq, int Skv, int H, int Dh, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBq][Dh]
  float* Ks = Qs + kBq * Dh;                    // [kBk][Dh + 4]
  float* Vs = Ks + kBk * (Dh + 4);              // [kBk][Dh]
  float* Ps = Vs + kBk * Dh;                    // [kBq][kBk + 1]
  const int ldk = Dh + 4;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBq;
  const int D = H * Dh;
  const int tid = threadIdx.x;
  const int r = tid / kRowThreads, sub = tid % kRowThreads;
  const int nd = Dh / kRowThreads;  // output columns per thread: sub + 8j

  for (int i = tid; i < kBq * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh, s = q0 + rr;
    Qs[i] = s < Sq ? q[((size_t)b * Sq + s) * D + h * Dh + d] : 0.f;
  }

  float o[kMaxDh / kRowThreads];
#pragma unroll
  for (int j = 0; j < kMaxDh / kRowThreads; ++j) o[j] = 0.f;
  float m = kNegBig, l = 0.f;
  const float* mrow = mask + (size_t)b * Skv;

  for (int k0 = 0; k0 < Skv; k0 += kBk) {
    __syncthreads();  // Q is loaded; the last tile's K, V and P are read
    for (int i = tid; i < kBk * Dh; i += kThreads) {
      const int c = i / Dh, d = i % Dh, s = k0 + c;
      const size_t g = ((size_t)b * Skv + s) * D + h * Dh + d;
      Ks[c * ldk + d] = s < Skv ? k[g] : 0.f;
      Vs[c * Dh + d] = s < Skv ? v[g] : 0.f;
    }
    __syncthreads();

    // s for keys sub + 8j of this tile
    float sc[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) sc[j] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(Qs + r * Dh);
    for (int d4 = 0; d4 < Dh / 4; ++d4) {
      const float4 qv = q4[d4];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float4 kv = reinterpret_cast<const float4*>(
            Ks + (sub + kRowThreads * j) * ldk)[d4];
        sc[j] = fmaf(qv.x, kv.x, sc[j]);
        sc[j] = fmaf(qv.y, kv.y, sc[j]);
        sc[j] = fmaf(qv.z, kv.z, sc[j]);
        sc[j] = fmaf(qv.w, kv.w, sc[j]);
      }
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int c = k0 + sub + kRowThreads * j;
      if (c < Skv)
        sc[j] = mrow[c] == 0.f ? kNegBig : sc[j] * scale;
      else
        sc[j] = -INFINITY;  // past the keys: weight exactly 0
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, row_max(tmax));
    const float rescale = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      Ps[r * (kBk + 1) + sub + kRowThreads * j] = p;
    }
    l = l * rescale + row_sum(psum);
    m = m_new;
    __syncwarp();  // a row's 8 threads are lanes of one warp

#pragma unroll
    for (int j = 0; j < kMaxDh / kRowThreads; ++j)
      if (j < nd) o[j] *= rescale;
    const float* prow = Ps + r * (kBk + 1);
    for (int c = 0; c < kBk; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * Dh + sub;
#pragma unroll
      for (int j = 0; j < kMaxDh / kRowThreads; ++j)
        if (j < nd) o[j] = fmaf(p, vrow[kRowThreads * j], o[j]);
    }
  }

  const int s = q0 + r;
  if (s < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + ((size_t)b * Sq + s) * D + h * Dh + sub;
#pragma unroll
    for (int j = 0; j < kMaxDh / kRowThreads; ++j)
      if (j < nd) orow[kRowThreads * j] = o[j] / denom;
  }
}

bool valid(int B, int Sq, int Skv, int H, int Dh) {
  return B >= 1 && Sq >= 1 && Skv >= 1 && H >= 1 && Dh >= 8 && Dh <= kMaxDh &&
         Dh % 8 == 0 && (long long)B * H <= 65535;
}

float head_scale(int Dh) { return (float)(1.0 / std::sqrt((double)Dh)); }

}  // namespace

extern "C" {

// Attention over q [B, Sq, H*Dh], k and v [B, Skv, H*Dh] into out (like q),
// with mask [B, Skv] f32 (0 = padded key), on `stream`. Dh in 8..128, a
// multiple of 8; B*H <= 65535. All contiguous; out 16-byte aligned. Returns
// the CUDA error of the launch (0 on success); the launch is asynchronous.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const float* mask, void* out, int B, int Sq, int Skv,
                         int H, int Dh, void* stream) {
  if (!valid(B, Sq, Skv, H, Dh)) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  const float sc = head_scale(Dh);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      Dh <= 64 ? launch_wgmma<1>(qb, kb, vb, mask, ob, B, Sq, Skv, H, Dh, sc, st)
               : launch_wgmma<2>(qb, kb, vb, mask, ob, B, Sq, Skv, H, Dh, sc, st);
  return (int)err;
}

int flash_attention_f32(const float* q, const float* k, const float* v,
                        const float* mask, float* out, int B, int Sq, int Skv,
                        int H, int Dh, void* stream) {
  if (!valid(B, Sq, Skv, H, Dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBq - 1) / kBq, B * H);
  flash_fwd_f32<<<grid, kThreads, smem, (cudaStream_t)stream>>>(q, k, v, mask, out, Sq,
                                                                Skv, H, Dh, head_scale(Dh));
  return (int)cudaGetLastError();
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
