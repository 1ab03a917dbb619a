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
// clips, layers 1-6 are 2.50 TFLOP at B=128, about 2.5 ms at the 989 TFLOP/s
// of bf16 tensor cores; reading x1 (1.68 GB) takes 0.5 ms at 3.35 TB/s, and
// with the intermediates this design writes and reads back, about 4.9 GB,
// 1.5 ms.
//
// Design: channels-last ([B, T, C]), the window of output frame t,
// x[b, 2t : 2t+K, :], is K*C contiguous values, so each layer is one GEMM
// whose A matrix is the overlapping-row view [T_out, K*C] with a row stride
// of 2C and whose B matrix is the layer's weights stacked [K*C, C]. No
// im2col copy is made. One launch per layer; the intermediates go through
// device memory (the TPU kernel's tile+halo scheme kept them in VMEM to
// feed the MXU, which a GEMM per layer does not need). bf16: 128x128 output
// tiles on the tensor cores (WMMA m16n16k16, f32 accumulators), A and B
// tiles double-buffered in shared memory by cp.async; the epilogue rounds,
// adds the bias and applies GELU before a 16-byte store. f32: a 64x64 tile
// of CUDA-core FMAs. With LN, the epilogue stops after the bias and one
// warp per frame applies LN and GELU in a second pass. WMMA through
// mma.sync reaches well under the card's wgmma peak; TMA and wgmma are the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

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
__device__ __forceinline__ float epilogue(float acc, T bias, bool gelu) {
  float z = round_to(round_to(acc, T{}) + to_float(bias), T{});
  return gelu ? round_to(gelu_of(z, T{}), T{}) : z;
}

// ---------------------------------------------------------------- bf16 GEMM

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;  // padded rows: 80 bytes, a multiple of 16
constexpr int kLdB = kBN + 8;  // 272 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// y[b, t, :] = epilogue(x[b, 2t : 2t+K, :] (flattened) @ w), w [K*C, C].
// Grid (ceil(T_out / 128), C / 128, B); 8 warps, each a 32x64 sub-tile.
__global__ void __launch_bounds__(kThreads)
conv_layer_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ y, int T_in,
                int T_out, int C, int Kdim, int gelu) {
  __shared__ __align__(128) bf16 As[2][kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[2][kBK * kLdB];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bf16* xb = x + (size_t)b * T_in * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;

  // Each stage is 512 16-byte chunks of A and 512 of B: two of each a thread.
  auto load_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      const int t = t0 + r;
      const bool in = t < T_out;
      cp_async16(&As[buf][r * kLdA + col],
                 in ? xb + (size_t)2 * t * C + k0 + col : xb, in);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(&Bs[buf][r * kLdB + col], w + (size_t)(k0 + r) * C + n0 + col,
                 true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = Kdim / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = As[kt & 1];
    const bf16* bm = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bm + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next step refills this buffer
  }

  // Epilogue through a 16x16 staging tile per warp: each lane finishes 8
  // consecutive channels of one frame and stores them as 16 bytes.
  float* st = stage[warp];
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int t = t0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c8;
      if (t < T_out) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(epilogue(st[r * 16 + c8 + e], bias[n + e], gelu));
        *reinterpret_cast<uint4*>(y + ((size_t)b * T_out + t) * C + n) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- f32 GEMM

constexpr int kFM = 64, kFN = 64, kFK = 16;

// The same GEMM in f32 on the CUDA cores. Grid (ceil(T_out / 64), C / 64, B);
// thread (ty, tx) owns rows 4ty..4ty+3 and columns 4tx..4tx+3 of the tile.
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
      y[((size_t)b * T_out + t) * C + n] = epilogue(acc[i][j], bias[n], gelu);
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

template <typename T>
cudaError_t launch_layer(const T* x, const T* w, const T* bias, T* y, int B,
                         int T_in, int T_out, int C, int K, bool gelu,
                         cudaStream_t stream);

template <>
cudaError_t launch_layer<bf16>(const bf16* x, const bf16* w, const bf16* bias,
                               bf16* y, int B, int T_in, int T_out, int C,
                               int K, bool gelu, cudaStream_t stream) {
  const dim3 grid((T_out + kBM - 1) / kBM, C / kBN, B);
  conv_layer_bf16<<<grid, kThreads, 0, stream>>>(x, w, bias, y, T_in, T_out, C,
                                                 K * C, gelu);
  return cudaGetLastError();
}

template <>
cudaError_t launch_layer<float>(const float* x, const float* w,
                                const float* bias, float* y, int B, int T_in,
                                int T_out, int C, int K, bool gelu,
                                cudaStream_t stream) {
  const dim3 grid((T_out + kFM - 1) / kFM, C / kFN, B);
  conv_layer_f32<<<grid, kThreads, 0, stream>>>(x, w, bias, y, T_in, T_out, C,
                                                K * C, gelu);
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
    cudaError_t err = launch_layer<T>(src, w + w_off, bias + (size_t)i * C, dst,
                                      B, len[i], len[i + 1], C, kTaps[i], !has_ln,
                                      stream);
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
// w: the six layers' weights, each [K*C, C] (row k*C + c_in, column c_out),
// one after the other; bias [6, C] in the working type; ln_scale, ln_shift
// [6, C] f32, read only when has_ln; scratch: B*(T2+T3)*C values of the
// working type. All contiguous and 16-byte aligned; C a multiple of 128.
// Returns the CUDA error of the launches (0 on success); asynchronous.
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
