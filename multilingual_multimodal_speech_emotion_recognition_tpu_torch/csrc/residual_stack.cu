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
// at about 70 us.
//
// Design: one block owns kRows batch rows and keeps them in shared memory
// across all L layers, so the activation never returns to device memory
// (what the Pallas kernel did with VMEM scratch). Each layer's two LNs are
// warp reductions, one warp per row. Each matrix product splits the output
// columns into float4 groups and the reduction dimension into slices, so a
// warp's loads of W[k, j..j+3] are coalesced and every thread keeps 8 of
// them in flight; the slices' partial sums are added in a fixed order, so
// the result does not change from run to run. Every block streams all of
// the weights, so a small batch uses few SMs and sits far above the
// bound; spreading one layer's columns over the whole card is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;      // batch rows owned by one block
constexpr int kThreads = 512;
constexpr int kUnroll = 8;    // weight loads in flight per thread
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp: dst = LN(src) * scale + bias over one row of D values.
__device__ void layer_norm_row(const float* src, float* dst,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, int D,
                               int lane) {
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s += src[k];
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float d = src[k] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + kEps);
  for (int k = lane; k < D; k += 32)
    dst[k] = (src[k] - mean) * rstd * __ldg(scale + k) + __ldg(bias + k);
}

// part[ks][r][j] = sum over k in slice ks of a[r][k] * W[k][j].
// Thread t owns column group cg = t % CG (columns 4cg..4cg+3) and slice
// ks = t / CG (rows k0..k1 of W).
__device__ void matmul_partial(const float* a, const float* __restrict__ W,
                               float* part, int D, int CG, int KS, int Kc) {
  const int t = threadIdx.x;
  if (t >= CG * KS) return;
  const int cg = t % CG, ks = t / CG;
  const int k0 = ks * Kc;
  const int k1 = min(D, k0 + Kc);
  const float4* W4 = reinterpret_cast<const float4*>(W) + cg;
  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = k0;
  for (; k + kUnroll <= k1; k += kUnroll) {
    float4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(W4 + (size_t)(k + u) * CG);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = a[r * D + k + u];
        acc[r].x = fmaf(av, w[u].x, acc[r].x);
        acc[r].y = fmaf(av, w[u].y, acc[r].y);
        acc[r].z = fmaf(av, w[u].z, acc[r].z);
        acc[r].w = fmaf(av, w[u].w, acc[r].w);
      }
    }
  }
  for (; k < k1; ++k) {
    const float4 w = __ldg(W4 + (size_t)k * CG);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a[r * D + k];
      acc[r].x = fmaf(av, w.x, acc[r].x);
      acc[r].y = fmaf(av, w.y, acc[r].y);
      acc[r].z = fmaf(av, w.z, acc[r].z);
      acc[r].w = fmaf(av, w.w, acc[r].w);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    reinterpret_cast<float4*>(part + ((size_t)ks * kRows + r) * D)[cg] = acc[r];
}

// Sum of the KS partial products of element (r, j), in slice order.
__device__ __forceinline__ float sum_slices(const float* part, int i, int KS,
                                            int D) {
  float s = 0.f;
  for (int ks = 0; ks < KS; ++ks) s += part[(size_t)ks * kRows * D + i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
residual_stack_kernel(const float* __restrict__ x,
                      const float* __restrict__ lnp_s,
                      const float* __restrict__ lnp_b,
                      const float* __restrict__ lnb_s,
                      const float* __restrict__ lnb_b,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int B, int L, int D, int KS, int Kc) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // [kRows][D] residual stream
  float* y = h + kRows * D;                    // LN_pre(h)
  float* t = y + kRows * D;                    // LN_blk(y)
  float* u = t + kRows * D;                    // relu(t @ W1 + b1)
  float* part = u + kRows * D;                 // [KS][kRows][D] partial sums

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const int CG = D / 4;
  const int n = kRows * D;

  // Rows past B are zeros: they stay finite and are never stored.
  for (int i = tid; i < n; i += kThreads) {
    const int r = i / D;
    h[i] = r < nrows ? x[(size_t)(row0 + r) * D + (i - r * D)] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t v = (size_t)l * D;
    const size_t m = (size_t)l * D * D;
    if (warp < kRows) {
      layer_norm_row(h + warp * D, y + warp * D, lnp_s + v, lnp_b + v, D, lane);
      __syncwarp();
      layer_norm_row(y + warp * D, t + warp * D, lnb_s + v, lnb_b + v, D, lane);
    }
    __syncthreads();
    matmul_partial(t, w1 + m, part, D, CG, KS, Kc);
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int j = i % D;
      u[i] = fmaxf(sum_slices(part, i, KS, D) + __ldg(b1 + v + j), 0.f);
    }
    __syncthreads();
    matmul_partial(u, w2 + m, part, D, CG, KS, Kc);
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int j = i % D;
      h[i] = y[i] + (sum_slices(part, i, KS, D) + __ldg(b2 + v + j));
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D;
    out[(size_t)(row0 + r) * D + (i - r * D)] = h[i];
  }
}

}  // namespace

extern "C" {

// Launches the stack on `stream`. x, out: [B, D]; w1, w2: [L, D, D] stored
// [in, out]; the other vectors [L, D]. All f32, contiguous, 16-byte aligned.
// D must be a multiple of 4 and at most 4 * kThreads. Returns the CUDA error
// of the launch (0 on success); the launch is asynchronous.
int residual_stack_f32(const float* x, const float* lnp_s, const float* lnp_b,
                       const float* lnb_s, const float* lnb_b, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       float* out, int B, int L, int D, void* stream) {
  if (B < 1 || L < 1 || D < 4 || D % 4 != 0 || D / 4 > kThreads)
    return (int)cudaErrorInvalidValue;
  const int CG = D / 4;
  const int KS = kThreads / CG;
  const int Kc = (D + KS - 1) / KS;
  const size_t smem = sizeof(float) * (size_t)kRows * D * (4 + KS);
  cudaError_t err = cudaFuncSetAttribute(
      residual_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRows - 1) / kRows;
  residual_stack_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, lnp_s, lnp_b, lnb_s, lnb_b, w1, b1, w2, b2, out, B, L, D, KS, Kc);
  return (int)cudaGetLastError();
}

const char* residual_stack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
