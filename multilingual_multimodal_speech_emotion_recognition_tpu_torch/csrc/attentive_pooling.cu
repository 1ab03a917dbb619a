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
// Design: one block per batch row walks S in tiles of 32 frames. A tile of
// x goes to shared memory once, as f32; the score MLP [32, D] x [D, H] runs
// inside the block with each thread owning one hidden unit j and 32*H/256
// frames, W1 read from L2 coalesced across j; the scores never go to
// device memory. The H hidden units of a frame are summed warp by warp and
// then over warps in a fixed order, so results do not vary between runs.
// s1 and s2 live in shared memory, one owner thread per channel. The MLP
// runs on the CUDA cores in f32, far from the bound while B is large; a
// tensor-core MLP and more than one block per row are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

const char* attentive_pooling_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
