// GroupNorm32 + activation for Hopper (sm_90a): bf16 or fp32 in and out,
// f32 statistics.
//
// Replaces the TPU kernel diffuncertainty_tpu/ops/pallas_groupnorm.py::_kernel
// (pallas_call at :126). Same function, in the same order: for batch element b
// of a contiguous channels-last (B, S, C) tensor (S = H*W or T), the f32
// per-channel sum and sum of squares over S; their combine into G groups of
// C/G consecutive channels; mean = sum/n and var = max(sumsq/n - mean^2, 0)
// with n = S*C/G; inv = 1/sqrt(var + eps); the affine folded into
// a = inv*scale, b = bias - mean*a; y = x*a + b; the activation (none, SiLU,
// ReLU) in f32; the cast back to the input type. The TPU kernel's lane fold
// (f = 128/C) is a layout trick for its 128-lane registers and has no
// counterpart here.
//
// Design (first, simple version): one block per batch element. A batch
// element is up to 1 MB (bf16) or 2 MB (fp32) on the main path, far more than
// shared memory, so the block makes two passes over it in device memory.
// Threads read 16 bytes each (8 bf16 or 4 fp32 values: one "vector"); the
// block size is a multiple of C/vector, so a thread meets the same channels
// at every step and keeps their partial sums and, in pass two, their a and b
// in registers. Pass one accumulates per-thread f32 partials, which a fixed
// tree over shared memory reduces to per-channel and then per-group sums (no
// atomics: the result does not change from run to run). Pass two reads the
// element again, normalises, applies the activation and writes it.
//
// Bound on the H100: memory. The function reads each input once and writes
// each output once (2 bytes a value in bf16, 4 in fp32) at 3.35 TB/s; it does
// about 10 flops a value, far below the fp32 rate. This version reads the
// input twice (the second read is served from L2 only where an element's
// slab is small), so it moves 1.5x the bytes of the bound at best.
//
// Limits: C % vector == 0; C <= kMaxChannels; the block size (at most
// kMaxThreads, a multiple of 32 and of C/vector) is chosen by the caller;
// x and y 16-byte aligned. The host function returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxChannels = 1024;
constexpr int kUnroll = 4;

enum Act { kNone = 0, kSilu = 1, kRelu = 2 };

template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  static constexpr int N = 4;
};
template <>
struct VecOf<__nv_bfloat16> {
  static constexpr int N = 8;
};

// One 16-byte packet: 4 fp32 or 8 bf16 values. Loads stay packed until used,
// so an unrolled group of loads costs 4 registers each.
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(pairs[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) pairs[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kSilu) return y / (1.0f + expf(-y));
  if (ACT == kRelu) return fmaxf(y, 0.0f);
  return y;
}

// Per-channel total of one per-thread partial: part[t * V + j] holds thread
// t's partial for the j-th channel of its vector slot t % cv.
template <int V>
__device__ __forceinline__ void reduce_channels(const float* part, float* out, int c, int cv) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int slot = ch / V;
    const int j = ch % V;
    float acc = 0.0f;
    for (int t = slot; t < static_cast<int>(blockDim.x); t += cv) acc += part[t * V + j];
    out[ch] = acc;
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    group_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y, long long per_elem,
                          int c, int groups, float n, float eps) {
  constexpr int V = VecOf<T>::N;
  __shared__ float part[kMaxThreads * V];
  __shared__ float ch_a[kMaxChannels];  // channel sums, then the folded a
  __shared__ float ch_b[kMaxChannels];  // channel sums of squares, then b
  __shared__ float g_mean[kMaxChannels];
  __shared__ float g_inv[kMaxChannels];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cv = c / V;  // vector slots per pixel; nt % cv == 0
  const long long nvec = per_elem / V;
  const T* xb = x + static_cast<long long>(blockIdx.x) * per_elem;
  T* yb = y + static_cast<long long>(blockIdx.x) * per_elem;

  // pass 1: per-thread f32 partial sums of the thread's V channels
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0f;
  long long i = tid;
  for (; i + (kUnroll - 1) * static_cast<long long>(nt) < nvec; i += kUnroll * nt) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = load_raw(xb + (i + u * nt) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[V];
      unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += v[j];
        q[j] += v[j] * v[j];
      }
    }
  }
  for (; i < nvec; i += nt) {
    float v[V];
    unpack(load_raw(xb + i * V), v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] += v[j];
      q[j] += v[j] * v[j];
    }
  }

  // per-channel totals, one partial array at a time
#pragma unroll
  for (int j = 0; j < V; ++j) part[tid * V + j] = s[j];
  __syncthreads();
  reduce_channels<V>(part, ch_a, c, cv);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) part[tid * V + j] = q[j];
  __syncthreads();
  reduce_channels<V>(part, ch_b, c, cv);
  __syncthreads();

  // group statistics
  const int cpg = c / groups;
  for (int g = tid; g < groups; g += nt) {
    float gs = 0.0f, gq = 0.0f;
    for (int k = 0; k < cpg; ++k) {
      gs += ch_a[g * cpg + k];
      gq += ch_b[g * cpg + k];
    }
    const float mean = gs / n;
    const float var = fmaxf(gq / n - mean * mean, 0.0f);
    g_mean[g] = mean;
    g_inv[g] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += nt) {
    const int g = ch / cpg;
    const float a = g_inv[g] * scale[ch];
    ch_a[ch] = a;
    ch_b[ch] = bias[ch] - g_mean[g] * a;
  }
  __syncthreads();

  // pass 2: y = act(x * a + b) for the thread's fixed channels
  float a[V], b[V];
  const int ch0 = (tid % cv) * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = ch_a[ch0 + j];
    b[j] = ch_b[ch0 + j];
  }
  i = tid;
  for (; i + (kUnroll - 1) * static_cast<long long>(nt) < nvec; i += kUnroll * nt) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = load_raw(xb + (i + u * nt) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[V];
      unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = activate<ACT>(v[j] * a[j] + b[j]);
      store_vec(yb + (i + u * nt) * V, v);
    }
  }
  for (; i < nvec; i += nt) {
    float v[V];
    unpack(load_raw(xb + i * V), v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = activate<ACT>(v[j] * a[j] + b[j]);
    store_vec(yb + i * V, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, int act,
                   long long batch, long long per_elem, int c, int groups, int threads, float n,
                   float eps, cudaStream_t stream) {
  constexpr int V = VecOf<T>::N;
  if (c % V != 0 || per_elem % c != 0 || threads % 32 != 0 || threads % (c / V) != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(batch));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (act) {
    case kNone:
      group_norm_act_kernel<T, kNone>
          <<<grid, threads, 0, stream>>>(xt, scale, bias, yt, per_elem, c, groups, n, eps);
      break;
    case kSilu:
      group_norm_act_kernel<T, kSilu>
          <<<grid, threads, 0, stream>>>(xt, scale, bias, yt, per_elem, c, groups, n, eps);
      break;
    case kRelu:
      group_norm_act_kernel<T, kRelu>
          <<<grid, threads, 0, stream>>>(xt, scale, bias, yt, per_elem, c, groups, n, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (batch, per_elem / c, c) contiguous, 16-byte aligned, of the type
// named by dtype (0 = fp32, 1 = bf16); scale, bias: (c,) fp32. act: 0 none,
// 1 SiLU, 2 ReLU. Returns a cudaError_t value (0 on success).
int group_norm_act(const void* x, const void* scale, const void* bias, void* y, int dtype,
                   int act, long long batch, long long per_elem, int c, int groups, int threads,
                   float eps, void* stream, int device) {
  if (batch <= 0 || per_elem <= 0 || c <= 0 || c > kMaxChannels || groups <= 0 ||
      c % groups != 0 || threads <= 0 || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float n = static_cast<float>(per_elem / c) * static_cast<float>(c / groups);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  switch (dtype) {
    case 0:
      return launch<float>(x, sc, bi, y, act, batch, per_elem, c, groups, threads, n, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, sc, bi, y, act, batch, per_elem, c, groups, threads, n,
                                   eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
