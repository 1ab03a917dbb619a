// wav2vec2 conv-extractor front in group mode: conv 0 (1 -> C channels,
// kernel 10, stride 5), its masked group norm (GroupNorm(C, C), statistics
// over each clip's valid frames only) and GELU, written channels-last as
// [B, T1, C], the input that the tail (conv_tail.cu, layers 1-6) takes.
//
// Replaces no TPU kernel: the JAX package computes conv 0 and its norm with
// lax.conv and jnp, and the port's unfused path with cuDNN and a dozen f32
// elementwise passes and reductions over the [B, C, T1] output, then a
// transpose for the tail. This kernel reads the waveform and writes the
// bf16 output once.
//
// Bound on an H100: bytes. At 1024 audio-seconds (B=512 clips of 2 s), the
// bf16 output is 1.68 G values, 3.36 GB, 1.0 ms at 3.35 TB/s; the waveform
// is 33 MB. The products are 10 multiply-adds an output computed three
// times (two statistics passes and the apply pass), 101 GFLOP, 1.5 ms at
// the 67 TFLOP/s of f32 FMAs; with the norm, GELU and roundings the CUDA
// cores do about 50 instructions an output, so the apply pass is bound by
// instruction throughput rather than by memory.
//
// Rounding points, as the unfused path: the conv-0 product in f32 from
// bf16 operands, rounded once to bf16 (plus the bias in bf16, rounded,
// where conv 0 has one); mean and variance per (clip, channel) in f32 over
// the valid frames (two passes: the mean, then the squared deviations from
// it), count (len - 10) / 5 + 1 clamped to at least 1; (x - mean) *
// rsqrt(var + eps) * scale + bias, each operation rounded in f32 as torch's
// elementwise kernels round them, then to bf16; the tanh GELU in f32 from
// that bf16 value, rounded to bf16. Padded frames take the same value.
//
// Design: two launches, deterministic (no atomics).
// - stats: one block per (clip, 64-channel chunk); 16 threads own 4
//   channels each and 16 frame slices split each tile of 256 frames. The
//   block stages the tile's waveform in shared memory as f32, and each
//   thread slides a 10-sample window over its 16 frames (5 new samples a
//   frame, shared memory broadcast). Partial sums go per tile, then per
//   thread, then over the slices in a fixed order. Pass 2 recomputes conv 0
//   for the squared deviations; the clip's waveform is read again from L2.
// - apply: one block per (clip, tile of 64 frames), C / 4 threads, each
//   owning 4 channels of every frame of the tile; a frame's C channels are
//   one contiguous row, written by the block as 8 bytes a thread.
// Each clip's valid length is read on the card from `samples`, so the
// launch reads nothing back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTaps = 10;
constexpr int kStride = 5;
constexpr int kCpt = 4;                // channels a thread owns
// stats
constexpr int kStatChannels = 64;      // channels a block owns
constexpr int kStatGroups = kStatChannels / kCpt;   // 16 channel groups
constexpr int kSlices = 16;            // frame slices of a tile
constexpr int kSliceFrames = 16;       // frames a slice takes per tile
constexpr int kStatFrames = kSlices * kSliceFrames;  // 256 frames a tile
constexpr int kStatThreads = kStatGroups * kSlices;  // 256
constexpr int kStatSamples = kStride * (kStatFrames - 1) + kTaps;
// apply
constexpr int kApplyFrames = 64;
constexpr int kApplySamples = kStride * (kApplyFrames - 1) + kTaps;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// torch's tanh GELU (ActivationGeluKernel.cu) in f32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// Frames of conv 0 over `len` valid samples: (len - 10) // 5 + 1, at most
// T1, and 0 where the clip is shorter than the kernel.
__device__ __forceinline__ int valid_frames(long long len, int T1) {
  if (len < kTaps) return 0;
  const long long n = (len - kTaps) / kStride + 1;
  return n < T1 ? (int)n : T1;
}

// The conv-0 output of one frame for the thread's 4 channels, rounded to
// bf16, from a window of 10 samples.
__device__ __forceinline__ void conv0(const float (&w)[kCpt][kTaps], const float (&bias)[kCpt],
                                      bool has_bias, const float (&x)[kTaps],
                                      float (&out)[kCpt]) {
#pragma unroll
  for (int c = 0; c < kCpt; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc = fmaf(w[c][k], x[k], acc);
    out[c] = round_bf16(acc);
    if (has_bias) out[c] = round_bf16(out[c] + bias[c]);
  }
}

__device__ __forceinline__ void load_weights(const bf16* __restrict__ w,
                                             const bf16* __restrict__ b, int c0,
                                             float (&wr)[kCpt][kTaps], float (&br)[kCpt]) {
#pragma unroll
  for (int c = 0; c < kCpt; ++c) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) wr[c][k] = __bfloat162float(w[(c0 + c) * kTaps + k]);
    br[c] = b ? __bfloat162float(b[c0 + c]) : 0.f;
  }
}

// Stage samples [s0, s0 + count) of one clip as f32, zeros past T.
__device__ __forceinline__ void stage(const bf16* __restrict__ wave, long long T,
                                      long long s0, int count, float* xs) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    xs[i] = s0 + i < T ? __bfloat162float(wave[s0 + i]) : 0.f;
}

// Pass 1 (kDeviations false): the sum of the valid frames' values of the
// thread's channels; pass 2: the sum of their squared deviations from
// `mean`. Returned per thread, for the block's fixed-order reduction.
template <bool kDeviations>
__device__ __forceinline__ void frame_sums(const bf16* __restrict__ wave, long long T, int n,
                                           const float (&w)[kCpt][kTaps],
                                           const float (&bias)[kCpt], bool has_bias,
                                           const float (&mean)[kCpt], float* xs,
                                           float (&sum)[kCpt]) {
  const int slice = threadIdx.x / kStatGroups;
#pragma unroll
  for (int c = 0; c < kCpt; ++c) sum[c] = 0.f;
  for (int f0 = 0; f0 < n; f0 += kStatFrames) {
    __syncthreads();
    stage(wave, T, (long long)kStride * f0, kStatSamples, xs);
    __syncthreads();
    const int first = f0 + slice * kSliceFrames;
    const float* x = xs + kStride * slice * kSliceFrames;
    float win[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) win[k] = x[k];
    float part[kCpt] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kSliceFrames; ++i) {
      if (i > 0) {
#pragma unroll
        for (int k = 0; k < kTaps - kStride; ++k) win[k] = win[k + kStride];
#pragma unroll
        for (int k = kTaps - kStride; k < kTaps; ++k) win[k] = x[kStride * i + k];
      }
      if (first + i < n) {
        float v[kCpt];
        conv0(w, bias, has_bias, win, v);
#pragma unroll
        for (int c = 0; c < kCpt; ++c) {
          if (kDeviations) {
            const float d = v[c] - mean[c];
            part[c] = fmaf(d, d, part[c]);
          } else {
            part[c] += v[c];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCpt; ++c) sum[c] += part[c];
  }
}

// Block sum over the slices of each channel, slice 0 first; returns the
// channel's total to thread `group` of slice 0 (other threads: 0).
__device__ __forceinline__ void reduce_slices(const float (&sum)[kCpt], float* red,
                                              float (&total)[kCpt]) {
  const int group = threadIdx.x % kStatGroups, slice = threadIdx.x / kStatGroups;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCpt; ++c) red[slice * kStatChannels + group * kCpt + c] = sum[c];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCpt; ++c) {
    total[c] = 0.f;
    if (slice == 0)
      for (int s = 0; s < kSlices; ++s) total[c] += red[s * kStatChannels + group * kCpt + c];
  }
}

__global__ void __launch_bounds__(kStatThreads)
front_stats(const bf16* __restrict__ wave, const long long* __restrict__ samples,
            const bf16* __restrict__ w, const bf16* __restrict__ b, float2* __restrict__ stats,
            int T, int T1, int C, float eps) {
  __shared__ float xs[kStatSamples];
  __shared__ float red[kSlices * kStatChannels];
  __shared__ float mean_s[kStatChannels];
  const int clip = blockIdx.y;
  const int group = threadIdx.x % kStatGroups, slice = threadIdx.x / kStatGroups;
  const int c0 = blockIdx.x * kStatChannels + group * kCpt;
  const int n = valid_frames(samples[clip], T1);
  const float count = n > 0 ? (float)n : 1.f;
  const bf16* x = wave + (size_t)clip * T;
  float wr[kCpt][kTaps], br[kCpt];
  load_weights(w, b, c0, wr, br);

  float sum[kCpt], total[kCpt], mean[kCpt] = {0.f, 0.f, 0.f, 0.f};
  frame_sums<false>(x, T, n, wr, br, b != nullptr, mean, xs, sum);
  reduce_slices(sum, red, total);
  if (slice == 0) {
#pragma unroll
    for (int c = 0; c < kCpt; ++c) mean_s[group * kCpt + c] = total[c] / count;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCpt; ++c) mean[c] = mean_s[group * kCpt + c];
  frame_sums<true>(x, T, n, wr, br, b != nullptr, mean, xs, sum);
  reduce_slices(sum, red, total);
  if (slice == 0) {
#pragma unroll
    for (int c = 0; c < kCpt; ++c)
      stats[(size_t)clip * C + c0 + c] = make_float2(mean[c], rsqrtf(total[c] / count + eps));
  }
}

__global__ void front_apply(const bf16* __restrict__ wave, const bf16* __restrict__ w,
                            const bf16* __restrict__ b, const float2* __restrict__ stats,
                            const float* __restrict__ scale, const float* __restrict__ shift,
                            bf16* __restrict__ out, int T, int T1, int C) {
  __shared__ float xs[kApplySamples];
  const int clip = blockIdx.y;
  const int f0 = blockIdx.x * kApplyFrames;
  const int c0 = threadIdx.x * kCpt;
  stage(wave + (size_t)clip * T, T, (long long)kStride * f0, kApplySamples, xs);
  float wr[kCpt][kTaps], br[kCpt], mu[kCpt], rs[kCpt], sc[kCpt], sh[kCpt];
  load_weights(w, b, c0, wr, br);
#pragma unroll
  for (int c = 0; c < kCpt; ++c) {
    const float2 s = stats[(size_t)clip * C + c0 + c];
    mu[c] = s.x;
    rs[c] = s.y;
    sc[c] = scale[c0 + c];
    sh[c] = shift[c0 + c];
  }
  __syncthreads();
  const int frames = min(kApplyFrames, T1 - f0);
  bf16* row = out + ((size_t)clip * T1 + f0) * C + c0;
  float win[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) win[k] = xs[k];
  for (int i = 0; i < frames; ++i) {
    if (i > 0) {
#pragma unroll
      for (int k = 0; k < kTaps - kStride; ++k) win[k] = win[k + kStride];
#pragma unroll
      for (int k = kTaps - kStride; k < kTaps; ++k) win[k] = xs[kStride * i + k];
    }
    float v[kCpt];
    conv0(wr, br, b != nullptr, win, v);
    float y[kCpt];
#pragma unroll
    for (int c = 0; c < kCpt; ++c) {
      // four roundings in f32, as four elementwise kernels round them
      float z = __fmul_rn(__fsub_rn(v[c], mu[c]), rs[c]);
      z = __fadd_rn(__fmul_rn(z, sc[c]), sh[c]);
      y[c] = gelu_tanh(round_bf16(z));
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<uint2*>(row + (size_t)i * C) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

}  // namespace

extern "C" {

// Conv 0 with its masked group norm and GELU, from wave [B, T] (bf16, the
// normalised waveform) and samples [B] (int64, each clip's valid samples)
// into out [B, T1, C] bf16, T1 = (T - 10) / 5 + 1, on `stream`. w [C, 10]
// bf16; b [C] bf16 or null; scale, shift [C] f32; stats: B*C float2 of
// scratch. All contiguous; C a multiple of 128, at most 4096. Returns the
// CUDA error of the launches (0 on success); asynchronous.
int conv_front_bf16(const void* wave, const long long* samples, const void* w, const void* b,
                    const float* scale, const float* shift, void* stats, void* out, int B,
                    int T, int C, float eps, void* stream) {
  if (B < 1 || B > 65535 || T < kTaps || C < 128 || C % 128 != 0 || C / kCpt > 1024)
    return (int)cudaErrorInvalidValue;
  const int T1 = (T - kTaps) / kStride + 1;
  const bf16* x = static_cast<const bf16*>(wave);
  const bf16* wk = static_cast<const bf16*>(w);
  const bf16* bk = static_cast<const bf16*>(b);
  float2* st = static_cast<float2*>(stats);
  cudaStream_t s = (cudaStream_t)stream;
  front_stats<<<dim3(C / kStatChannels, B), kStatThreads, 0, s>>>(x, samples, wk, bk, st, T, T1,
                                                                   C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  front_apply<<<dim3((T1 + kApplyFrames - 1) / kApplyFrames, B), C / kCpt, 0, s>>>(
      x, wk, bk, st, scale, shift, static_cast<bf16*>(out), T, T1, C);
  return (int)cudaGetLastError();
}

const char* conv_front_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
