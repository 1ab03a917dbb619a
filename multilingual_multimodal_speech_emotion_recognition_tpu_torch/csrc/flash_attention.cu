// Masked multi-head attention, forward: online softmax over KV tiles.
//
// Replaces the TPU kernel flash_attention
// (multilingual_multimodal_speech_emotion_recognition_tpu/ops/pallas_kernels.py:295,
// body _flash_kernel :259). Per head: s = (q . k) * scale with scale
// 1/sqrt(Dh) applied after the product; s = -1e30 where kv_mask == 0;
// running max m (from -1e30), normaliser l and accumulator o in f32, the
// probabilities kept in f32 through p . v; out = o / max(l, 1e-30).
//
// Bound on an H100: q, k, v and out are read or written once. At the
// wav2vec2-base self-attention (B=128, S=199, D=768, bf16) that is 156 MB,
// 47 us at 3.35 TB/s; the q.k products (7.8 GFLOP, tensor-core work on bf16
// inputs) take 8 us at 989 TFLOP/s, and the p.v products, whose p is f32,
// 117 us at the 67 TFLOP/s of f32 FMAs, so the f32 p.v that the TPU
// kernel's numerics ask for bounds it at about 125 us.
//
// Design: one block per (batch * head, 32-query tile), 256 threads; 8
// threads share a query row, so the row's max and sum are 8-lane shuffles.
// Each KV tile of 64 keys is staged in shared memory as f32; q.k reads K
// four values at a time. Heads are read by stride from [B, S, H*Dh]: no
// transpose copy. Keys past Skv weigh exactly 0; a row whose keys are all
// masked therefore averages v over its Skv keys (the TPU kernel, which pads
// keys into the average, is undefined there too). All in f32 on the CUDA
// cores: simple, and the p.v bound above is an f32 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBq = 32;       // query rows per block
constexpr int kBk = 64;       // keys per KV tile
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kBq;  // 8 threads per query row
constexpr int kKeysPerThread = kBk / kRowThreads;
constexpr int kMaxDh = 128;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ mask,
          T* __restrict__ out, int Sq, int Skv, int H, int Dh, float scale) {
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
    Qs[i] = s < Sq ? to_float(q[((size_t)b * Sq + s) * D + h * Dh + d]) : 0.f;
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
      Ks[c * ldk + d] = s < Skv ? to_float(k[g]) : 0.f;
      Vs[c * Dh + d] = s < Skv ? to_float(v[g]) : 0.f;
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
    T* orow = out + ((size_t)b * Sq + s) * D + h * Dh + sub;
#pragma unroll
    for (int j = 0; j < kMaxDh / kRowThreads; ++j)
      if (j < nd) store(orow + kRowThreads * j, o[j] / denom);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* mask, T* out,
           int B, int Sq, int Skv, int H, int Dh, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Dh < 8 || Dh > kMaxDh ||
      Dh % 8 != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBq - 1) / kBq, B * H);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, Sq, Skv,
                                                 H, Dh,
                                                 (float)(1.0 / std::sqrt((double)Dh)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Attention over q [B, Sq, H*Dh], k and v [B, Skv, H*Dh] into out (like q),
// with mask [B, Skv] f32 (0 = padded key), on `stream`. Dh in 8..128, a
// multiple of 8; B*H <= 65535. All contiguous. Returns the CUDA error of
// the launch (0 on success); the launch is asynchronous.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const float* mask, void* out, int B, int Sq, int Skv,
                         int H, int Dh, void* stream) {
  return launch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), mask,
                      static_cast<bf16*>(out), B, Sq, Skv, H, Dh,
                      (cudaStream_t)stream);
}

int flash_attention_f32(const float* q, const float* k, const float* v,
                        const float* mask, float* out, int B, int Sq, int Skv,
                        int H, int Dh, void* stream) {
  return launch<float>(q, k, v, mask, out, B, Sq, Skv, H, Dh,
                       (cudaStream_t)stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
