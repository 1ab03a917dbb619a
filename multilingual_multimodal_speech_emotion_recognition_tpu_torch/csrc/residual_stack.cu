// Eval-path residual stack of the classifier head, fused into one launch.
//
// Replaces the TPU kernel residual_stack_pallas
// (multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:114).
// Per layer l of L:  y = LN_pre(h);  h = y + (relu(LN_blk(y) @ W1 + b1) @ W2 + b2)
// in f32, LN eps 1e-5 with two-pass f32 moments, W stored [in, out].
//
// Bound on an H100: the weights are read once, L * 2 * D * D * 4 bytes
// (73.4 MB at L=35, D=512), about 22 us at 3.35 TB/s while B is small; at
// B=128 the 4.7 GFLOP of f32 FMAs on the CUDA cores (67 TFLOP/s) bound it
// at about 70 us. What stands between the kernel and those bounds is the
// chain of 2L dependent matrix products: each needs all of the previous
// one's output, so a layer cannot start before the whole card has finished
// the one before it. One block streaming all the weights, as this kernel
// first did, runs at one SM's read rate whatever B.
//
// Design: one persistent grid, launched cooperatively so that every block
// is resident, spreads each product over the card.
// - A block owns one column group J (`cw` output columns, cw / 4 a power of
//   two, the last group cut at D) and every `row_blocks`-th group of `rows`
//   batch rows; the plan (ops/residual_stack.py:plan) sizes both.
// - Each layer runs in two phases, each ended by a grid barrier written by
//   hand (an arrival counter, __threadfence before arriving, a spin on an
//   acquire load): phase A reads the block's rows of h in full from L2,
//   computes y = LN_pre(h) and t = LN_blk(y) in shared memory, keeps y[:, J]
//   in a global buffer for its own phase B and writes u[:, J] =
//   relu(t W1[:, J] + b1[J]); phase B reads its rows of u in full and writes
//   h[:, J] = y[:, J] + u W2[:, J] + b2[J] (h lives in `out`). Buffers
//   written by other SMs are read with ld.global.cg (L2), never through the
//   non-coherent path.
// - The weights do not depend on the activation, so they stream ahead of
//   the chain: each block's strips W[m][:, J] (matrix m = 2l for W1[l],
//   2l + 1 for W2[l]) go through a ring of `depth` shared-memory slots, as
//   deep as 227 KB allow, filled by tensor copies (TMA) that complete on one
//   mbarrier per slot. One thread issues them while thread 0 waits at the
//   grid barrier, so the copies cost the chain nothing. The layer's LN
//   vectors and the strip's biases ride in the same slot, so no global load
//   but the exchanged rows stays on the chain. Up to `depth` strips are in
//   flight.
// - Each LN is one warp's, on rows held in registers.
// - Inside a block a product splits the output columns into float4 quads
//   and the reduction over k, in runs of four, into 32 / (cw / 4) lanes x
//   8 warps; lanes sum by xor shuffles and warps through shared memory,
//   always in the same order, and each output element is computed by one
//   block, so the result is the same from run to run. Rows past B are
//   zeros and never stored.
//
// What bounds it now (chip_smoke.py on an H100; PERF.md): neither bytes
// nor FMAs but the latency of each phase's chain: the grid barrier, the L2
// round trip of the exchanged rows, the LNs and the product's reduction,
// each a dependent step. Exchanging through distributed shared memory in
// 16-block clusters with the hardware cluster barrier instead timed the
// same at B=4 and was not kept.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr float kEps = 1e-5f;

struct Params {
  CUtensorMap w1_map, w2_map;  // W1, W2 [L, D, D] as {cols, k % 4, k / 4, layer}
  const float* x;  // [B, D]
  const float* lnp_s;
  const float* lnp_b;
  const float* lnb_s;
  const float* lnb_b;  // [L, D] each
  const float* b1;
  const float* b2;  // [L, D] each
  float* out;       // [B, D]: h between layers, the result after the last
  float* u;         // [B, D]: relu(t W1 + b1), exchanged between blocks
  float* y;         // [B, D]: LN_pre(h), read back by the block that wrote it
  unsigned* arrivals;  // grid-barrier counter, zero at launch
  int B, L, D, cw, col_groups, row_blocks, depth;
};

__host__ __device__ constexpr int barrier_bytes(int depth) {
  return (8 * depth + 15) / 16 * 16;
}

// A strip's rows k = 4 k4 + j are stored as four planes j of [plane_k4(D)]
// [cw], each filled by tma_boxes(D) tensor copies of box_k4(D) rows k4 (a
// box spans at most 256 rows; rows past D / 4 arrive as zeros). Planes and
// boxes start on 128 bytes, as tensor copies want.
__host__ __device__ constexpr int tma_boxes(int D) { return (D / 4 + 255) / 256; }
__host__ __device__ constexpr int box_k4(int D) {
  return ((D / 4 + tma_boxes(D) - 1) / tma_boxes(D) + 7) / 8 * 8;
}
__host__ __device__ constexpr int plane_k4(int D) { return tma_boxes(D) * box_k4(D); }

// A ring slot: the column strip of one matrix, then the layer's four LN
// vectors (used with W1) and the strip's cw bias values, padded to 128 bytes.
__host__ __device__ constexpr size_t slot_floats(int D, int cw) {
  return ((size_t)4 * plane_k4(D) * cw + 4 * (size_t)D + cw + 31) / 32 * 32;
}

// 128 bytes of slack to align the ring, the ring, its mbarriers, the
// [rows, D] activation and the warps' partial sums.
__host__ __device__ constexpr size_t smem_bytes(int rows, int D, int cw, int depth) {
  return 128 + sizeof(float) * depth * slot_floats(D, cw) + barrier_bytes(depth) +
         sizeof(float) * ((size_t)rows * D + (size_t)kWarps * rows * cw);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The ring starts at the first 128-byte boundary of the dynamic shared
// memory (smem_bytes holds the slack).
__device__ __forceinline__ float* ring_base(unsigned char* smem) {
  const uint32_t raw = smem_addr(smem);
  return reinterpret_cast<float*>(smem + (((raw + 127) & ~127u) - raw));
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

// Arrives on `bar` and adds `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A tensor copy (TMA) of one box of `map` at coordinates {c0, c1, c2, c3}
// into shared memory, counted on the mbarrier `bar` when it lands.
__device__ __forceinline__ void tensor_copy_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk asynchronous copy of `bytes` (a multiple of 16) from global to
// shared memory, counted on the mbarrier `bar` when it lands.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Each s[w] becomes its sum over the warp's lanes.
template <int RW>
__device__ __forceinline__ void warp_sums(float (&s)[RW]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int w = 0; w < RW; ++w) s[w] += __shfl_xor_sync(0xffffffffu, s[w], o);
}

// All blocks of the grid wait here until `target` arrivals have been
// counted; the writes each block made before it are then visible to all.
// While thread 0 arrives and waits, thread 32 runs `work`.
template <typename Work>
__device__ __forceinline__ void grid_barrier(unsigned* arrivals, unsigned target,
                                             Work&& work) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(arrivals)
                   : "memory");
    } while (seen < target);
    __threadfence();
  } else if (threadIdx.x == 32) {
    work();
  }
  __syncthreads();
}

// One warp: v[w] = LN(v[w]) * scale + bias for RW rows at once (their
// shuffles interleave), each row held as float4s v[w][i] = row[4 (lane +
// 32 i) ...] in registers; V >= D / 128.
template <int RW, int V>
__device__ __forceinline__ void layer_norm_regs(float4 (&v)[RW][V], const float* scale,
                                                const float* bias, int D, int lane) {
  const int n4 = D / 4;
  float mean[RW], rstd[RW];
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    mean[w] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < n4) mean[w] += (v[w][i].x + v[w][i].y) + (v[w][i].z + v[w][i].w);
  }
  warp_sums(mean);
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    mean[w] /= D;
    rstd[w] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < n4) {
        const float4 d = make_float4(v[w][i].x - mean[w], v[w][i].y - mean[w],
                                     v[w][i].z - mean[w], v[w][i].w - mean[w]);
        rstd[w] += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
      }
    }
  }
  warp_sums(rstd);
#pragma unroll
  for (int w = 0; w < RW; ++w) rstd[w] = rsqrtf(rstd[w] / D + kEps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k4 = lane + 32 * i;
    if (k4 < n4) {
      const float4 g = reinterpret_cast<const float4*>(scale)[k4];
      const float4 b = reinterpret_cast<const float4*>(bias)[k4];
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        v[w][i].x = (v[w][i].x - mean[w]) * rstd[w] * g.x + b.x;
        v[w][i].y = (v[w][i].y - mean[w]) * rstd[w] * g.y + b.y;
        v[w][i].z = (v[w][i].z - mean[w]) * rstd[w] * g.z + b.z;
        v[w][i].w = (v[w][i].w - mean[w]) * rstd[w] * g.w + b.w;
      }
    }
  }
}

// One warp, phase A of rows r0 + w * kWarps (w < RW) of act [R][D]: each
// row becomes t = LN_blk(y) with y = LN_pre(row); y's columns [c0, c0 + cw)
// of row r go to y[r * D + (0 .. cw)] for r < nr.
template <int RW, int V>
__device__ __forceinline__ void layer_norms_rows(float* act, int r0, const float* vec, float* y,
                                                 int nr, int D, int c0, int cw, int lane) {
  const int n4 = D / 4;
  float4 v[RW][V];
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const float4* row = reinterpret_cast<const float4*>(act + (size_t)(r0 + w * kWarps) * D);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k4 = lane + 32 * i;
      v[w][i] = k4 < n4 ? row[k4] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  layer_norm_regs<RW, V>(v, vec, vec + D, D, lane);
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = r0 + w * kWarps;
    if (r >= nr) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = 4 * (lane + 32 * i);
      if (k < D && k >= c0 && k < c0 + cw)
        *reinterpret_cast<float4*>(y + (size_t)r * D + (k - c0)) = v[w][i];
    }
  }
  layer_norm_regs<RW, V>(v, vec + 2 * D, vec + 3 * D, D, lane);
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    float4* row = reinterpret_cast<float4*>(act + (size_t)(r0 + w * kWarps) * D);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < n4) row[lane + 32 * i] = v[w][i];
  }
}

// One thread (lane 0 of warp 1) copies the column strip of matrix m, with
// its layer's LN vectors (for W1) and its bias values, into its ring slot:
// the strip by tensor copies (TMA) of [box_k4, cw] boxes, the vectors by
// bulk copies, all completing on the slot's mbarrier. The strip's rows are
// stored as planes [4][plane_k4][cw], row k at (k % 4) * plane_k4 + k / 4,
// so that the lanes of matmul_partial read consecutive addresses. Columns past D (the
// last group's ragged edge) arrive as zeros; the sums they feed are never
// stored.
__device__ __forceinline__ void issue_strip(const Params& p, int m, int c0, float* ring,
                                            uint64_t* bars) {
  const int slot = m % p.depth;
  const int l = m >> 1;
  const size_t v = (size_t)l * p.D;
  const int plane = plane_k4(p.D), box = box_k4(p.D);
  float* dst = ring + slot * slot_floats(p.D, p.cw);
  float* vec = dst + (size_t)4 * plane * p.cw;
  const uint32_t bar = smem_addr(bars + slot);
  const uint32_t bias_bytes = 4 * min(p.cw, p.D - c0);
  // the slot's last reads were the generic proxy's; these writes are the async proxy's
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, 16 * plane * p.cw + bias_bytes + ((m & 1) ? 0 : 16 * p.D));
  const CUtensorMap* map = (m & 1) ? &p.w2_map : &p.w1_map;
  for (int j = 0; j < 4; ++j)
    for (int k4 = 0; k4 < plane; k4 += box)
      tensor_copy_4d(smem_addr(dst + (size_t)(j * plane + k4) * p.cw), map, bar, c0, j, k4, l);
  if (!(m & 1)) {
    bulk_copy(smem_addr(vec), p.lnp_s + v, 4 * p.D, bar);
    bulk_copy(smem_addr(vec + p.D), p.lnp_b + v, 4 * p.D, bar);
    bulk_copy(smem_addr(vec + 2 * p.D), p.lnb_s + v, 4 * p.D, bar);
    bulk_copy(smem_addr(vec + 3 * p.D), p.lnb_b + v, 4 * p.D, bar);
  }
  bulk_copy(smem_addr(vec + 4 * p.D), ((m & 1) ? p.b2 : p.b1) + v + c0, bias_bytes, bar);
}

// act[r][:] = src[row0 + r][:] for r < nr, zeros for the rows past B.
// src was written by other SMs: read it from L2.
template <int R>
__device__ void load_rows(const float* src, float* act, int row0, int nr, int D) {
  const int d4 = D / 4;
  float4* a4 = reinterpret_cast<float4*>(act);
  for (int i = threadIdx.x; i < R * d4; i += kThreads) {
    const int r = i / d4;
    a4[i] = r < nr ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D) +
                            (i - r * d4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// part[warp][r][c] = this warp's share of sum_k act[r][k] * strip[k][c].
// Lane = quad + nq * kl; a thread takes k in runs of four (one float4 of
// each act row). For each of the four, a warp reads 32 / nq consecutive
// rows of the permuted strip, contiguous in shared memory.
template <int R>
__device__ void matmul_partial(const float* act, const float* strip, float* part,
                               int D, int cw) {
  const int nq = cw / 4;
  const int kls = 32 / nq;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int quad = lane % nq, kl = lane / nq;
  const int n4 = D / 4;
  const int step = kls * kWarps;
  const float4* w4 = reinterpret_cast<const float4*>(strip) + quad;
  const int plane = plane_k4(D) * nq;  // float4s of one k % 4 plane of the strip
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int k4 = kl + kls * warp; k4 < n4; k4 += step) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = w4[j * plane + k4 * nq];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = reinterpret_cast<const float4*>(act + r * D)[k4];
      float4& c = acc[r];
      c.x = fmaf(a.x, w[0].x, c.x); c.y = fmaf(a.x, w[0].y, c.y);
      c.z = fmaf(a.x, w[0].z, c.z); c.w = fmaf(a.x, w[0].w, c.w);
      c.x = fmaf(a.y, w[1].x, c.x); c.y = fmaf(a.y, w[1].y, c.y);
      c.z = fmaf(a.y, w[1].z, c.z); c.w = fmaf(a.y, w[1].w, c.w);
      c.x = fmaf(a.z, w[2].x, c.x); c.y = fmaf(a.z, w[2].y, c.y);
      c.z = fmaf(a.z, w[2].z, c.z); c.w = fmaf(a.z, w[2].w, c.w);
      c.x = fmaf(a.w, w[3].x, c.x); c.y = fmaf(a.w, w[3].y, c.y);
      c.z = fmaf(a.w, w[3].z, c.z); c.w = fmaf(a.w, w[3].w, c.w);
    }
  }
  for (int o = 16; o >= nq; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, o);
      acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, o);
      acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, o);
      acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, o);
    }
  }
  if (kl == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      reinterpret_cast<float4*>(part + ((size_t)warp * R + r) * cw)[quad] = acc[r];
  }
}

template <int R, int V>
__global__ void __launch_bounds__(kThreads, 1) residual_stack_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = ring_base(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + p.depth * slot_floats(p.D, p.cw));
  float* act = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) +
                                        barrier_bytes(p.depth));  // [R][D]: t or u rows
  float* part = act + (size_t)R * p.D;                             // [kWarps][R][cw]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D, cw = p.cw;
  const int c0 = (blockIdx.x % p.col_groups) * cw;
  const int first_group = blockIdx.x / p.col_groups;
  const int row_groups = (p.B + R - 1) / R;
  const int M = 2 * p.L;

  if (tid == 0) {
    for (int s = 0; s < p.depth; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 32)
    for (int m = 0; m < p.depth && m < M; ++m) issue_strip(p, m, c0, ring, bars);

  unsigned barriers = 0;
  for (int m = 0; m < M; ++m) {
    mbar_wait(smem_addr(bars + m % p.depth), (m / p.depth) & 1);
    const float* strip = ring + (m % p.depth) * slot_floats(D, cw);
    const float* vec = strip + (size_t)4 * plane_k4(D) * cw;  // LN_pre s, b, LN_blk s, b; bias
    const bool phase_b = m & 1;

    for (int g = first_group; g < row_groups; g += p.row_blocks) {
      const int row0 = g * R;
      const int nr = min(R, p.B - row0);
      // Output element j of this thread is i = tid + j * kThreads of the
      // [R, cw] tile; in phase B its y is fetched now, off the critical path.
      constexpr int kOut = (R * 128 + kThreads - 1) / kThreads;
      float yv[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int i = tid + j * kThreads, r = i / cw, c = i - r * cw;
        yv[j] = phase_b && i < R * cw && r < nr && c0 + c < D
                    ? __ldcg(p.y + (size_t)(row0 + r) * D + c0 + c)
                    : 0.f;
      }
      load_rows<R>(phase_b ? p.u : (m == 0 ? p.x : p.out), act, row0, nr, D);
      __syncthreads();
      if (!phase_b) {
        // two rows a warp at once where R = 16, unless the rows are wide
        constexpr int RW = R > kWarps && V <= 8 ? R / kWarps : 1;
        for (int r = warp; r < R; r += kWarps * RW)
          layer_norms_rows<RW, V>(act, r, vec, p.y + (size_t)row0 * D + c0, nr, D, c0, cw, lane);
        __syncthreads();
      }
      matmul_partial<R>(act, strip, part, D, cw);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int i = tid + j * kThreads, r = i / cw, c = i - r * cw;
        if (i >= R * cw || r >= nr || c0 + c >= D) continue;
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * R + r) * cw + c];
        const size_t o = (size_t)(row0 + r) * D + c0 + c;
        if (!phase_b)
          __stcg(p.u + o, fmaxf(s + vec[4 * D + c], 0.f));
        else
          __stcg(p.out + o, yv[j] + (s + vec[4 * D + c]));
      }
      __syncthreads();
    }
    // Matrix m's slot is free once every thread is at the barrier: while
    // thread 0 waits there, thread 32 starts matrix m + depth into it.
    if (m + 1 < M)
      grid_barrier(p.arrivals, ++barriers * gridDim.x, [&] {
        if (m + p.depth < M) issue_strip(p, m + p.depth, c0, ring, bars);
      });
  }
}

template <int R, int V>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&residual_stack_kernel<R, V>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params args = p;
  void* argv[] = {&args};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(p.col_groups * p.row_blocks),
                                          dim3(kThreads), argv, smem, stream);
}

// The LN keeps a row in V float4s per lane: the least power of two with
// 128 V >= D, so that its unrolled loops carry no dead iterations.
template <int R>
int launch_rows(const Params& p, size_t smem, cudaStream_t stream) {
  if (p.D <= 128) return launch<R, 1>(p, smem, stream);
  if (p.D <= 256) return launch<R, 2>(p, smem, stream);
  if (p.D <= 512) return launch<R, 4>(p, smem, stream);
  if (p.D <= 1024) return launch<R, 8>(p, smem, stream);
  return launch<R, 16>(p, smem, stream);
}

// W [L, D, D] as a 4-D f32 tensor map {cols, k % 4, k / 4, layer}, whose
// [cw, 1, box_k4, 1] boxes are strip rows k = 4 k4 + j of one j.
bool encode_strip_map(CUtensorMap* map, const float* w, int L, int D, int cw) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, 4, (cuuint64_t)D / 4, (cuuint64_t)L};
  const cuuint64_t strides[3] = {(cuuint64_t)4 * D, (cuuint64_t)16 * D, (cuuint64_t)4 * D * D};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)box_k4(D), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(w),
                                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Launches the stack on `stream` as one cooperative grid of
// col_groups * row_blocks blocks. x, out, u, y: [B, D]; w1, w2: [L, D, D]
// stored [in, out]; the other vectors [L, D]; all f32, contiguous, 16-byte
// aligned. arrivals: one zeroed unsigned int. The plan (rows in {4, 8, 16},
// cw a multiple of 4 with cw / 4 a power of two up to 32, col_groups =
// ceil(D / cw), row_blocks at most the number of row groups, depth >= 1)
// comes from ops/residual_stack.py:plan. Returns the CUDA error of the
// launch (0 on success; cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be resident at once); the launch is asynchronous.
int residual_stack_f32(const float* x, const float* lnp_s, const float* lnp_b,
                       const float* lnb_s, const float* lnb_b, const float* w1,
                       const float* b1, const float* w2, const float* b2, float* out,
                       float* u, float* y, unsigned* arrivals, int B, int L, int D,
                       int rows, int cw, int col_groups, int row_blocks, int depth,
                       void* stream) {
  const int nq = cw / 4;
  const int row_groups = rows > 0 ? (B + rows - 1) / rows : 0;
  if (B < 1 || L < 1 || D < 4 || D % 4 != 0 || D > 2048 || cw < 4 || cw % 4 != 0 ||
      nq > 32 || 32 % nq != 0 || col_groups != (D + cw - 1) / cw || row_blocks < 1 ||
      row_blocks > row_groups || depth < 1 || (rows != 4 && rows != 8 && rows != 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, D, cw, depth);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{};
  if (!encode_strip_map(&p.w1_map, w1, L, D, cw) || !encode_strip_map(&p.w2_map, w2, L, D, cw))
    return (int)cudaErrorInvalidValue;
  p.x = x; p.lnp_s = lnp_s; p.lnp_b = lnp_b; p.lnb_s = lnb_s; p.lnb_b = lnb_b;
  p.b1 = b1; p.b2 = b2; p.out = out; p.u = u; p.y = y;
  p.arrivals = arrivals;
  p.B = B; p.L = L; p.D = D; p.cw = cw; p.col_groups = col_groups;
  p.row_blocks = row_blocks; p.depth = depth;
  cudaStream_t s = (cudaStream_t)stream;
  return rows == 4 ? launch_rows<4>(p, smem, s)
                   : rows == 8 ? launch_rows<8>(p, smem, s) : launch_rows<16>(p, smem, s);
}

const char* residual_stack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
