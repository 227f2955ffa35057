// Fused-qkv self-attention forward for Hopper (sm_90a): bf16 in and out,
// f32 scores, softmax statistics and PV accumulation.
//
// Replaces the TPU kernel diffuncertainty_tpu/ops/pallas_attention.py::_qkv_kernel
// (pallas_call at :135). Same function: per batch row b and head h, q, k and v
// are the slices [3D*h, 3D*h + D), [.. + D, .. + 2D), [.. + 2D, .. + 3D) of the
// fused (B, T, 3C) projection (the ADM "legacy" head split, D = C / H);
// s = (q . k^T accumulated in f32) * scale2, with scale2 = D^-1/2 applied after
// the accumulation; m = rowmax(s); e = exp(s - m); l = rowsum(e) in f32;
// o = (bf16(e) . v accumulated in f32) / l, written as bf16 to channels
// [D*h, D*(h+1)) of the (B, T, C) output.
//
// Design (first, simple version): one block per (query tile, head, batch row),
// one thread per query row. The head's K and V (T x D bf16 each) are staged in
// shared memory once; every thread then walks all keys, reading each K/V row as
// a warp-wide broadcast. TWO PASSES over the keys, not an online softmax: pass
// one finds the row max, pass two forms e, its f32 sum and bf16(e) . v. This
// reproduces the TPU kernel's rounding exactly (e is cast to the input dtype
// before PV, the output is divided by l afterwards); only the order of f32
// sums differs. The cost is computing q . k twice.
//
// Bound on the H100: at the main path's shapes (B=256, H=4) the work is
// 4*B*H*T^2*D flops on tensor-core-eligible bf16 operands (137 GFLOP at
// T=1024, D=32; 17 GFLOP at T=256, D=64) against 3*B*T*C*2 + B*T*C*2 bytes.
// T=1024 is compute-bound and T=256 memory-bound on the card. This version
// runs the products on the f32 FMA pipes, not the tensor cores, so it is
// far from that bound; mma/wgmma tiles are the next step.
//
// Limits: D in {32, 64}; 2*T*D*2 bytes of K/V must fit the 227 KB of shared
// memory a block may use (T <= 1816 at D=32, T <= 908 at D=64). The host
// function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90

template <int D>
__device__ __forceinline__ void load_row(const __nv_bfloat16* src, float* dst) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pairs[k]);
      dst[8 * c + 2 * k] = f.x;
      dst[8 * c + 2 * k + 1] = f.y;
    }
  }
}

// q . k_row in f32, four partial sums for instruction-level parallelism.
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k_row) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(k_row)[c];
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(pairs[k]);
      acc[k] = fmaf(q[8 * c + 2 * k], f.x, acc[k]);
      acc[k] = fmaf(q[8 * c + 2 * k + 1], f.y, acc[k]);
    }
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int D, int NT>
__global__ void __launch_bounds__(NT)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     int T, int C, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + static_cast<size_t>(T) * D;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* head = qkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h;

  constexpr int kVec = D / 8;  // 16-byte chunks in one row of q, k or v
  for (int idx = threadIdx.x; idx < T * kVec; idx += NT) {
    const int j = idx / kVec;
    const int c = idx % kVec;
    const uint4* row = reinterpret_cast<const uint4*>(head + j * c3);
    reinterpret_cast<uint4*>(ks + static_cast<size_t>(j) * D)[c] = row[kVec + c];
    reinterpret_cast<uint4*>(vs + static_cast<size_t>(j) * D)[c] = row[2 * kVec + c];
  }
  __syncthreads();

  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= T) return;  // no barrier follows

  float q[D];
  load_row<D>(head + i * c3, q);

  // pass 1: row max of the scaled scores
  float m = -INFINITY;
  for (int j = 0; j < T; ++j) {
    m = fmaxf(m, dot_row<D>(q, ks + static_cast<size_t>(j) * D) * scale2);
  }

  // pass 2: e = exp(s - m), l = sum(e) in f32, o = bf16(e) . v in f32
  float o[D];
#pragma unroll
  for (int c = 0; c < D; ++c) o[c] = 0.f;
  float l = 0.f;
  for (int j = 0; j < T; ++j) {
    const float e = expf(dot_row<D>(q, ks + static_cast<size_t>(j) * D) * scale2 - m);
    l += e;
    const float eb = __bfloat162float(__float2bfloat16(e));
    const __nv_bfloat16* v_row = vs + static_cast<size_t>(j) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(v_row)[c];
      const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(pairs[k]);
        o[8 * c + 2 * k] = fmaf(eb, f.x, o[8 * c + 2 * k]);
        o[8 * c + 2 * k + 1] = fmaf(eb, f.y, o[8 * c + 2 * k + 1]);
      }
    }
  }

  __nv_bfloat16* dst = out + (static_cast<size_t>(b) * T + i) * C + static_cast<size_t>(D) * h;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint4 raw;
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pairs[k] = __floats2bfloat162_rn(o[8 * c + 2 * k] / l, o[8 * c + 2 * k + 1] / l);
    }
    reinterpret_cast<uint4*>(dst)[c] = raw;
  }
}

template <int D, int NT>
cudaError_t launch(const void* qkv, void* out, int B, int T, int C, int H, float scale2,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(T) * D * sizeof(__nv_bfloat16);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return cudaErrorInvalidValue;
  auto kernel = qkv_attention_kernel<D, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + NT - 1) / NT, H, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                     static_cast<__nv_bfloat16*>(out), T, C, scale2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: (B, T, 3C) bf16 contiguous, 16-byte aligned; out: (B, T, C) bf16.
// Returns a cudaError_t value (0 on success).
int qkv_attention_bf16(const void* qkv, void* out, int B, int T, int C, int H, float scale2,
                       void* stream, int device) {
  if (B <= 0 || T <= 0 || H <= 0 || C % H != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 32:
      return launch<32, 512>(qkv, out, B, T, C, H, scale2, s);
    case 64:
      return launch<64, 256>(qkv, out, B, T, C, H, scale2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
