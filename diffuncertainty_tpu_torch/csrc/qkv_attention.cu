// Fused-qkv self-attention forward for Hopper (sm_90a): bf16 in and out,
// products on the tensor cores with f32 accumulation, f32 softmax statistics.
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
// Bound on the H100: the algorithm's work is one q.k^T and one PV product,
// 4*B*H*T^2*D operations on bf16 operands, against (3*B*T*C + B*T*C)*2 bytes
// (q, k, v read once, the output written once). At the main path's shapes
// (B=256, H=4) that is 137 GFLOP against 268 MB at T=1024, D=32 (bound by
// operations: 0.139 ms at 989 TFLOP/s) and 17 GFLOP against 134 MB at T=256,
// D=64 (bound by bytes: 0.040 ms at 3.35 TB/s). The bound counts the single
// q.k^T of the algorithm, not the second pass's.
//
// Design. One block of 4 warps per (64-query tile, head, batch row); each warp
// owns 16 query rows and keeps their q as mma A fragments in registers. K and
// V stream through shared memory in 64-key tiles, double-buffered with 16-byte
// cp.async copies, so the next tile loads while the tensor cores work on this
// one and T has no shared-memory cap. Both products are warp-level
// mma.sync.m16n8k16 bf16 -> f32: B fragments come from ldmatrix (K as is, V
// transposed) on rows padded to an odd number of 16-byte chunks, so the eight
// row addresses of each ldmatrix phase fall in distinct banks. The score
// accumulator of PV's left operand never leaves registers: the m16n8 C-fragment
// layout of two adjacent key tiles is the m16k16 A-fragment layout, so bf16(e)
// is packed in place. The q.k^T depth is padded to a multiple of 16 with zeros
// (cp.async zero-fill, D=24 -> 32); ragged key tiles are zero-filled and their
// scores masked to -inf; ragged query rows are computed and not stored. The
// output goes through shared memory so each row is stored in 16-byte pieces.
//
// Two passes over the keys, not an online softmax. Pass one only tracks the row
// max of the raw accumulator (scale2 > 0, so max(acc) * scale2 is bit for bit
// max(acc * scale2)) and needs no exp. Pass two recomputes the scores, forms
// e = exp(s - m) against the final max, sums e in f32 and feeds bf16(e) to PV:
// this is the TPU kernel's rounding (e rounded against the final max, the
// division after PV). An online softmax would round e against a running max
// and rescale the accumulator, changing that rounding; at D <= 64 its extra
// rescaling work is about what the repeated q.k^T costs, since the exps (one
// per score) and not the mma rate set the pace there. exp is taken as exp2 of
// s*log2(e) - m*log2(e) in one fma (ex2.approx: a few f32 ulps from expf, and
// flushed to 0 below 2^-126), far below the bf16 step of e.
//
// Head widths: D in {16, 24, 32, 48, 64, 96, 128, 192}, every width the repo's
// networks give with 4 heads. Any T >= 1. The host function returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB opt-in limit per block on sm_90
constexpr int kQueryTile = 64;           // query rows per block
constexpr int kKeyTile = 64;             // keys per pipeline stage
constexpr int kWarps = 4;                // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kWarps * 16 == kQueryTile, "one m16 row block per warp");
static_assert(kKeyTile % 16 == 0, "key tiles are whole k16 steps of PV");

// Shared-memory geometry for head width D, in 16-byte chunks of 8 bf16.
template <int D>
struct Geometry {
  static_assert(D % 8 == 0, "rows of q, k and v must be whole 16-byte chunks");
  static constexpr int kDepth = (D + 15) / 16 * 16;           // q.k^T depth, zero padded
  static constexpr int kQkChunks = kDepth / 8 + 1;            // q and k row stride (odd)
  static constexpr int kVChunks = (D / 8) % 2 ? D / 8 : D / 8 + 1;  // v row stride (odd)
  static constexpr int kKeyNTiles = kKeyTile / 8;             // n8 tiles of a score tile
  static constexpr int kOutNTiles = D / 8;                    // n8 tiles of the output
  static constexpr int kSmemBytes =
      16 * (kQueryTile * kQkChunks + 2 * kKeyTile * (kQkChunks + kVChunks));
  static_assert(kSmemBytes <= kMaxSharedBytes, "tile does not fit shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a . b on the tensor cores: m16n8k16, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `rows` rows of kChunks 16-byte chunks, starting at token row0 of a
// source of `stride` elements a row, into a shared tile of row stride kStride
// chunks. Chunks at or past kDataChunks and rows at or past T are zero-filled.
template <int kChunks, int kDataChunks, int kStride>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, size_t stride,
                                          int row0, int rows, int T) {
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool valid = row0 + r < T && c < kDataChunks;
    const __nv_bfloat16* from =
        valid ? src + static_cast<size_t>(row0 + r) * stride + 8 * c : src;
    cp_async16(tile + 16 * (r * kStride + c), from, valid);
  }
}

// One warp's 16 x 64 score tile: s = q . k^T over the padded depth, f32.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[Geometry<D>::kKeyNTiles][4],
                                           const uint32_t (&qf)[Geometry<D>::kDepth / 16][4],
                                           uint32_t k_tile, int lane) {
  using G = Geometry<D>;
#pragma unroll
  for (int n = 0; n < G::kKeyNTiles; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  }
  // lanes 0-7 / 8-15 / 16-23 / 24-31 address keys +0-7, +0-7, +8-15, +8-15 at
  // depth chunks 2kk, 2kk+1, 2kk, 2kk+1: b0b1 and b2b3 of two n8 key tiles
  const int key = (lane >> 4) * 8 + (lane & 7);
  const int kchunk = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < G::kDepth / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < G::kKeyNTiles / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, k_tile + 16 * ((16 * np + key) * G::kQkChunks + 2 * kk + kchunk));
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int T, int C,
                     float scale2) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_tile = smem_addr(smem);
  const uint32_t k_tiles = q_tile + 16 * kQueryTile * G::kQkChunks;
  const uint32_t v_tiles = k_tiles + 2 * 16 * kKeyTile * G::kQkChunks;
  constexpr uint32_t kKBytes = 16 * kKeyTile * G::kQkChunks;
  constexpr uint32_t kVBytes = 16 * kKeyTile * G::kVChunks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kQueryTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* head = qkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h;
  const __nv_bfloat16* k_src = head + D;
  const __nv_bfloat16* v_src = head + 2 * D;

  const int n_tiles = (T + kKeyTile - 1) / kKeyTile;
  const int steps = 2 * n_tiles;  // pass one: tiles 0..n-1 (K); pass two: again (K and V)

  // prologue: the query tile and step 0's K
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(q_tile, head, c3, q0, kQueryTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(k_tiles, k_src, c3, 0, kKeyTile, T);
  cp_async_commit();

  uint32_t qf[G::kDepth / 16][4];
  float s[G::kKeyNTiles][4];
  float o[G::kOutNTiles][4];
#pragma unroll
  for (int n = 0; n < G::kOutNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
  float acc_max[2] = {-INFINITY, -INFINITY};
  float m_log2e[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f};

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {  // prefetch the next step into the other buffer
      const int next = step + 1;
      const int tile = next < n_tiles ? next : next - n_tiles;
      const uint32_t buf = next & 1;
      load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(k_tiles + buf * kKBytes, k_src, c3,
                                                     tile * kKeyTile, kKeyTile, T);
      if (next >= n_tiles) {
        load_tile<D / 8, D / 8, G::kVChunks>(v_tiles + buf * kVBytes, v_src, c3,
                                              tile * kKeyTile, kKeyTile, T);
      }
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this step
    cp_async_wait_one();
    __syncthreads();

    if (step == 0) {
      // lanes 0-7 / 8-15 / 16-23 / 24-31: rows +0-7, +8-15, +0-7, +8-15 at depth
      // chunks 2kk, 2kk, 2kk+1, 2kk+1: the a0a1, a2a3, a4a5, a6a7 of m16k16
      const int row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < G::kDepth / 16; ++kk) {
        ldmatrix_x4(qf[kk], q_tile + 16 * (row * G::kQkChunks + 2 * kk + (lane >> 4)));
      }
    }

    const uint32_t buf = step & 1;
    const int tile = step < n_tiles ? step : step - n_tiles;
    const int key_limit = T - tile * kKeyTile;  // keys of this tile at or past it are masked
    score_tile<D>(s, qf, k_tiles + buf * kKBytes, lane);
    if (key_limit < kKeyTile) {  // the ragged last tile: keys past T score -inf
#pragma unroll
      for (int n = 0; n < G::kKeyNTiles; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (8 * n + 2 * (lane & 3) + (j & 1) >= key_limit) s[n][j] = -INFINITY;
        }
      }
    }

    if (step < n_tiles) {
      // pass one: row max of the raw accumulator
#pragma unroll
      for (int n = 0; n < G::kKeyNTiles; ++n) {
        acc_max[0] = fmaxf(acc_max[0], fmaxf(s[n][0], s[n][1]));
        acc_max[1] = fmaxf(acc_max[1], fmaxf(s[n][2], s[n][3]));
      }
      if (step == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the quad holds one row's 64 columns
          acc_max[r] = fmaxf(acc_max[r], __shfl_xor_sync(0xffffffffu, acc_max[r], 1));
          acc_max[r] = fmaxf(acc_max[r], __shfl_xor_sync(0xffffffffu, acc_max[r], 2));
          m_log2e[r] = acc_max[r] * scale2 * kLog2e;
        }
      }
    } else {
      // pass two: e = exp(s - m) (0 for a masked key), l += e, o += bf16(e) . v
#pragma unroll
      for (int n = 0; n < G::kKeyNTiles; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = exp2_approx(fmaf(s[n][j] * scale2, kLog2e, -m_log2e[j >> 1]));
          l[j >> 1] += e;
          s[n][j] = e;
        }
      }
      const uint32_t v_tile = v_tiles + buf * kVBytes;
      // lanes 0-7 / 8-15 / 16-23 / 24-31 address keys +0-7, +8-15, +0-7, +8-15
      // at output chunks 2dp, 2dp, 2dp+1, 2dp+1: transposed, b0b1 and b2b3 of
      // two n8 output tiles
      const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t row = v_tile + 16 * (16 * kk + vkey) * G::kVChunks;
#pragma unroll
        for (int dp = 0; dp < G::kOutNTiles / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, row + 16 * (2 * dp + (lane >> 4)));
          mma_bf16(o[2 * dp], a, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
        }
        if constexpr (G::kOutNTiles % 2 != 0) {
          uint32_t bv[2];
          ldmatrix_x2_trans(bv, row + 16 * (G::kOutNTiles - 1));
          mma_bf16(o[G::kOutNTiles - 1], a, bv[0], bv[1]);
        }
      }
    }
    __syncthreads();  // the buffer just read is the next prefetch's target
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (m_out != nullptr && (lane & 3) == 0) {  // under grad: the row statistics
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + 16 * warp + (lane >> 2) + 8 * r;
      if (t < T) {
        const size_t i = (static_cast<size_t>(b) * gridDim.y + h) * T + t;
        m_out[i] = acc_max[r] * scale2;
        l_out[i] = l[r];
      }
    }
  }

  // o / l as bf16 into the warp's own 16 rows of the (now unused) query tile,
  // then 16-byte stores of the rows that exist
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int n = 0; n < G::kOutNTiles; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(stage + r0 * 8 * G::kQkChunks + col) =
        pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(stage + (r0 + 8) * 8 * G::kQkChunks + col) =
        pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8);
    const int c = idx % (D / 8);
    const int t = q0 + 16 * warp + r;
    if (t < T) {
      __nv_bfloat16* dst = out + (static_cast<size_t>(b) * T + t) * C + static_cast<size_t>(D) * h;
      reinterpret_cast<uint4*>(dst)[c] =
          reinterpret_cast<const uint4*>(stage + (16 * warp + r) * 8 * G::kQkChunks)[c];
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, void* out, float* m, float* l, int B, int T, int C, int H,
                   float scale2, cudaStream_t stream) {
  constexpr int smem = Geometry<D>::kSmemBytes;
  auto kernel = qkv_attention_kernel<D>;
  if constexpr (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                           static_cast<__nv_bfloat16*>(out), m, l, T, C, scale2);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward. No TPU kernel has one: the JAX custom_vjp at
// diffuncertainty_tpu/ops/pallas_attention.py:86-102 differentiates its XLA
// twin. These kernels compute the VJP of the same math (the port's twin,
// ops/cuda_attention.py::_attention_math): bf16(e) in PV and the division by
// l after PV. Per (b, h), with e[t,s] = exp(s[t,s] - m[t]) recomputed from q,
// k and the forward's row max m, and dO the incoming gradient:
//   dV[s] = sum_t bf16(e[t,s]) / l[t] * dO[t]
//   delta[t] = sum_c dO[t,c] * o[t,c] / l[t]
//   dS[t,s] = e[t,s] * (dO[t] . V[s] / l[t] - delta[t])
//   dQ = scale2 * dS K,  dK = scale2 * dS^T Q.
// The twin's gradient through the row max (-sum_s dS[t,s] to the argmax key)
// is zero in exact arithmetic and left out.
//
// Bound on the H100: operations. The work is five T x T x D products a head
// (the recomputed q.k^T, dV, dP, dQ, dK), 10*B*H*T^2*D operations on bf16
// operands, against qkv, o, dO, m, l read once and dqkv written once. At
// unet16's training sites (B=16, H=4): 21.5 GFLOP at T=1024, D=32 (0.022 ms
// at 989 TFLOP/s), and at T=256, D=64 17 MB (0.005 ms at 3.35 TB/s).
//
// Design: FlashAttention-2's split, with no atomics, so every gradient is
// written once by one block and two runs give the same bits.
// 1. attention_delta_kernel, one thread per (b, t, h): delta[t] and the row
//    constants {m*log2(e), 1/l, delta} of every row into a (B, H, T) float4
//    scratch, so the two kernels below load one 16-byte chunk a row.
// 2. attention_dkdv_kernel<D>, one block of 4 warps per (64-key tile, head,
//    batch row): its K and V rows stay in shared memory, each warp owns 16
//    keys and keeps their dK and dV in registers, and the block walks every
//    64-query tile (Q, dO and the row constants double-buffered with
//    cp.async). Per tile a warp forms S^T = K Q^T and e, dV += P^T dO with
//    P^T = bf16(e)/l as A fragments, dP^T = V dO^T, dS^T and dK += dS^T Q.
// 3. attention_dq_kernel<D>, one block per (64-query tile, head, batch row):
//    its Q and dO rows and row constants stay in shared memory, K and V
//    stream through double-buffered tiles, each warp keeps 16 rows of dQ.
// The products are the forward's warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulation) on ldmatrix fragments of odd-stride padded rows; the
// C-fragment-to-A-fragment repack feeds e and dS to the next product without
// shared memory. Operands are rounded to bf16 where they enter a product
// (bf16(e)/l, dS), as FlashAttention's backward does. Ragged tiles are
// zero-filled and their rows masked (e = 0) or not stored. A thread keeps
// D/2 floats each of dK and dV: at D = 128 the dK/dV kernel takes all 255
// registers and at D = 192 it spills (ptxas reports it); the networks train
// at D <= 64.

// The row constants of one row: {m * log2(e), 1 / l, delta, unused}.
__global__ void __launch_bounds__(kThreads)
attention_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ out,
                       const float* __restrict__ m, const float* __restrict__ l,
                       float4* __restrict__ rows, int B, int T, int C, int H) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;  // (b, t, h)
  if (i >= static_cast<long long>(B) * T * H) return;
  const int D = C / H;
  const int h = static_cast<int>(i % H);
  const long long bt = i / H;
  const int t = static_cast<int>(bt % T);
  const long long b = bt / T;
  const uint4* dp = reinterpret_cast<const uint4*>(dout + bt * C + static_cast<long long>(D) * h);
  const uint4* op = reinterpret_cast<const uint4*>(out + bt * C + static_cast<long long>(D) * h);
  float acc = 0.f;
  for (int c = 0; c < D / 8; ++c) {
    const uint4 draw = dp[c], oraw = op[c];
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&draw);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&oraw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 df = __bfloat1622float2(d2[k]);
      const float2 of = __bfloat1622float2(o2[k]);
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
    }
  }
  const long long s = (b * H + h) * T + t;
  const float linv = 1.0f / l[s];
  rows[s] = make_float4(m[s] * kLog2e, linv, acc * linv, 0.f);
}

// 64 rows of row constants (one 16-byte chunk each) from row row0 into a
// shared tile; rows at or past T are zero-filled.
__device__ __forceinline__ void load_rows(uint32_t tile, const float4* src, int row0, int T) {
  for (int idx = threadIdx.x; idx < kKeyTile; idx += kThreads) {
    const bool valid = row0 + idx < T;
    cp_async16(tile + 16 * idx, valid ? src + row0 + idx : src, valid);
  }
}

// acc = A . B^T over the padded depth, f32: A the warp's 16 rows of a shared
// tile, B the 64 rows of another (both of row stride kQkChunks).
template <int D>
__device__ __forceinline__ void nt_product(float (&acc)[kKeyTile / 8][4], uint32_t a_tile,
                                           uint32_t b_tile, int warp, int lane) {
  using G = Geometry<D>;
#pragma unroll
  for (int n = 0; n < kKeyTile / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // A: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows +0-7, +8-15, +0-7, +8-15
  // at depth chunks 2kk, 2kk, 2kk+1, 2kk+1; B as score_tile's K
  const int arow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int brow = (lane >> 4) * 8 + (lane & 7);
  const int bchunk = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < G::kDepth / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_tile + 16 * (arow * G::kQkChunks + 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < kKeyTile / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_tile + 16 * ((16 * np + brow) * G::kQkChunks + 2 * kk + bchunk));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc += P . B: P the warp's 16 x 64 operand as packed A fragments (one per
// k16 step), B the 64 rows (k) x D columns (n) of a shared tile of row stride
// kQkChunks, read transposed as the forward reads V.
template <int D>
__device__ __forceinline__ void pv_accumulate(float (&acc)[D / 8][4],
                                              const uint32_t (&a)[kKeyTile / 16][4],
                                              uint32_t b_tile, int lane) {
  using G = Geometry<D>;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    const uint32_t row = b_tile + 16 * (16 * kk + vrow) * G::kQkChunks;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, row + 16 * (2 * dp + (lane >> 4)));
      mma_bf16(acc[2 * dp], a[kk], bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], bv[2], bv[3]);
    }
    if constexpr ((D / 8) % 2 != 0) {
      uint32_t bv[2];
      ldmatrix_x2_trans(bv, row + 16 * (D / 8 - 1));
      mma_bf16(acc[D / 8 - 1], a[kk], bv[0], bv[1]);
    }
  }
}

// The 16 x 64 C fragments of p as the A fragments of the next product: the
// m16n8 layout of n8 tiles 2kk and 2kk+1 is the m16k16 layout of step kk.
__device__ __forceinline__ void pack_a(uint32_t (&a)[kKeyTile / 16][4],
                                       const float (&p)[kKeyTile / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stores a warp's 16 x D accumulator times `mul` as bf16 at column offset
// col0 of the dqkv rows row0 + 16*warp + ..., rows at or past T skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dqkv, const float (&acc)[D / 8][4],
                                           float mul, size_t c3, int row0, int T, int warp,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 16 * warp + (lane >> 2) + 8 * r;
    if (t >= T) continue;
    __nv_bfloat16* dst = dqkv + static_cast<size_t>(t) * c3;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * (lane & 3)) =
          pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int D>
struct BackwardGeometry {
  static constexpr int kTileBytes = 16 * kKeyTile * Geometry<D>::kQkChunks;
  // six 64-row tiles and two tiles of 64 row constants
  static constexpr int kSmemBytes = 6 * kTileBytes + 2 * 16 * kKeyTile;
  static_assert(kSmemBytes <= kMaxSharedBytes, "backward tiles do not fit shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                      const float4* __restrict__ rows, __nv_bfloat16* __restrict__ dqkv, int T,
                      int C, float scale2) {
  using G = Geometry<D>;
  constexpr uint32_t kTile = BackwardGeometry<D>::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t k_tile = smem_addr(smem);
  const uint32_t v_tile = k_tile + kTile;
  const uint32_t q_tiles = v_tile + kTile;        // two buffers
  const uint32_t do_tiles = q_tiles + 2 * kTile;  // two buffers
  const uint32_t r_tiles = do_tiles + 2 * kTile;  // two buffers of row constants
  const float4* r_smem = reinterpret_cast<const float4*>(smem + 6 * kTile);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s0 = blockIdx.x * kKeyTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* head = qkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h;
  const __nv_bfloat16* do_src = dout + static_cast<size_t>(b) * T * C + static_cast<size_t>(D) * h;
  const float4* r_src = rows + (static_cast<size_t>(b) * gridDim.y + h) * T;
  const int n_tiles = (T + kQueryTile - 1) / kQueryTile;

  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(k_tile, head + D, c3, s0, kKeyTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(v_tile, head + 2 * D, c3, s0, kKeyTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(q_tiles, head, c3, 0, kQueryTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(do_tiles, do_src, C, 0, kQueryTile, T);
  load_rows(r_tiles, r_src, 0, T);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int qt = 0; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) {  // prefetch the next query tile into the other buffers
      const uint32_t nb = (qt + 1) & 1;
      const int t0 = (qt + 1) * kQueryTile;
      load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(q_tiles + nb * kTile, head, c3, t0,
                                                     kQueryTile, T);
      load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(do_tiles + nb * kTile, do_src, C, t0,
                                                     kQueryTile, T);
      load_rows(r_tiles + nb * 16 * kKeyTile, r_src, t0, T);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const uint32_t buf = qt & 1;
    const uint32_t q_tile = q_tiles + buf * kTile;
    const uint32_t do_tile = do_tiles + buf * kTile;
    const float4* rc = r_smem + buf * kKeyTile;
    const int query_limit = T - qt * kQueryTile;  // query columns at or past it are masked

    // S^T = K Q^T and e = exp(s - m) by column (query)
    float e[kKeyTile / 8][4];
    nt_product<D>(e, k_tile, q_tile, warp, lane);
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * n + 2 * (lane & 3) + (j & 1);
        e[n][j] = col < query_limit
                      ? exp2_approx(fmaf(e[n][j] * scale2, kLog2e, -rc[col].x))
                      : 0.f;
      }
    }
    // dV += (bf16(e) / l)^T dO
    uint32_t a[kKeyTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        const int col = 8 * n + 2 * (lane & 3);
        const float l0 = rc[col].y, l1 = rc[col + 1].y;
        a[kk][2 * half] = pack_bf16(round_bf16(e[n][0]) * l0, round_bf16(e[n][1]) * l1);
        a[kk][2 * half + 1] = pack_bf16(round_bf16(e[n][2]) * l0, round_bf16(e[n][3]) * l1);
      }
    }
    pv_accumulate<D>(dv, a, do_tile, lane);
    // dP^T = V dO^T, then dS^T = e * (dP^T / l - delta), then dK += dS^T Q
    float dp[kKeyTile / 8][4];
    nt_product<D>(dp, v_tile, do_tile, warp, lane);
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 r = rc[8 * n + 2 * (lane & 3) + (j & 1)];
        e[n][j] *= fmaf(dp[n][j], r.y, -r.z);
      }
    }
    pack_a(a, e);
    pv_accumulate<D>(dk, a, q_tile, lane);
    __syncthreads();  // the buffers just read are the next prefetch's target
  }
  __nv_bfloat16* dst = dqkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h;
  store_rows<D>(dst + D, dk, scale2, c3, s0, T, warp, lane);
  store_rows<D>(dst + 2 * D, dv, 1.0f, c3, s0, T, warp, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                    const float4* __restrict__ rows, __nv_bfloat16* __restrict__ dqkv, int T,
                    int C, float scale2) {
  using G = Geometry<D>;
  constexpr uint32_t kTile = BackwardGeometry<D>::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_tile = smem_addr(smem);
  const uint32_t do_tile = q_tile + kTile;
  const uint32_t k_tiles = do_tile + kTile;      // two buffers
  const uint32_t v_tiles = k_tiles + 2 * kTile;  // two buffers
  const uint32_t r_tile = v_tiles + 2 * kTile;
  const float4* r_smem = reinterpret_cast<const float4*>(smem + 6 * kTile);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kQueryTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const __nv_bfloat16* head = qkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h;
  const __nv_bfloat16* do_src = dout + static_cast<size_t>(b) * T * C + static_cast<size_t>(D) * h;
  const float4* r_src = rows + (static_cast<size_t>(b) * gridDim.y + h) * T;
  const int n_tiles = (T + kKeyTile - 1) / kKeyTile;

  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(q_tile, head, c3, q0, kQueryTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(do_tile, do_src, C, q0, kQueryTile, T);
  load_rows(r_tile, r_src, q0, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(k_tiles, head + D, c3, 0, kKeyTile, T);
  load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(v_tiles, head + 2 * D, c3, 0, kKeyTile, T);
  cp_async_commit();

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float4 rc[2];  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const uint32_t nb = (kt + 1) & 1;
      const int k0 = (kt + 1) * kKeyTile;
      load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(k_tiles + nb * kTile, head + D, c3, k0,
                                                     kKeyTile, T);
      load_tile<G::kDepth / 8, D / 8, G::kQkChunks>(v_tiles + nb * kTile, head + 2 * D, c3, k0,
                                                     kKeyTile, T);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (kt == 0) {
      rc[0] = r_smem[16 * warp + (lane >> 2)];
      rc[1] = r_smem[16 * warp + (lane >> 2) + 8];
    }

    const uint32_t buf = kt & 1;
    const uint32_t k_tile = k_tiles + buf * kTile;
    const uint32_t v_tile = v_tiles + buf * kTile;
    const int key_limit = T - kt * kKeyTile;  // keys at or past it are masked

    float e[kKeyTile / 8][4];
    nt_product<D>(e, q_tile, k_tile, warp, lane);
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[n][j] = 8 * n + 2 * (lane & 3) + (j & 1) < key_limit
                      ? exp2_approx(fmaf(e[n][j] * scale2, kLog2e, -rc[j >> 1].x))
                      : 0.f;
      }
    }
    float dp[kKeyTile / 8][4];
    nt_product<D>(dp, do_tile, v_tile, warp, lane);
#pragma unroll
    for (int n = 0; n < kKeyTile / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[n][j] *= fmaf(dp[n][j], rc[j >> 1].y, -rc[j >> 1].z);
    }
    uint32_t a[kKeyTile / 16][4];
    pack_a(a, e);
    pv_accumulate<D>(dq, a, k_tile, lane);
    __syncthreads();
  }
  store_rows<D>(dqkv + static_cast<size_t>(b) * T * c3 + static_cast<size_t>(3 * D) * h, dq,
                scale2, c3, q0, T, warp, lane);
}

template <int D>
cudaError_t launch_backward(const void* qkv, const void* dout, const float4* rows, void* dqkv,
                            int B, int T, int C, int H, float scale2, cudaStream_t stream) {
  constexpr int smem = BackwardGeometry<D>::kSmemBytes;
  auto dkdv = attention_dkdv_kernel<D>;
  auto dq = attention_dq_kernel<D>;
  if constexpr (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + kKeyTile - 1) / kKeyTile, H, B);
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* dx = static_cast<__nv_bfloat16*>(dqkv);
  dkdv<<<grid, kThreads, smem, stream>>>(x, g, rows, dx, T, C, scale2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<grid, kThreads, smem, stream>>>(x, g, rows, dx, T, C, scale2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: (B, T, 3C) bf16 contiguous, 16-byte aligned; out: (B, T, C) bf16. m, l:
// (B, H, T) f32 for the row max of the scaled scores and the row sum of e,
// written when not null (the autograd forward), else not touched.
// Returns a cudaError_t value (0 on success).
int qkv_attention_bf16(const void* qkv, void* out, void* m, void* l, int B, int T, int C, int H,
                       float scale2, void* stream, int device) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || C % H != 0 ||
      (m == nullptr) != (l == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  switch (C / H) {
    case 16:
      return launch<16>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 24:
      return launch<24>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 32:
      return launch<32>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 48:
      return launch<48>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 64:
      return launch<64>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 96:
      return launch<96>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 128:
      return launch<128>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    case 192:
      return launch<192>(qkv, out, mf, lf, B, T, C, H, scale2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward: dqkv (B, T, 3C) bf16 from qkv, the forward's out (B, T, C)
// bf16, dout = dL/dout (B, T, C) bf16 (all contiguous, 16-byte aligned), and
// the forward's m and l (B, H, T) f32; rows is (B, H, T) float4 scratch. Three
// launches on the stream. Returns a cudaError_t value (0 on success).
int qkv_attention_backward_bf16(const void* qkv, const void* out, const void* dout,
                                const void* m, const void* l, void* rows, void* dqkv, int B,
                                int T, int C, int H, float scale2, void* stream, int device) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || C % H != 0 || (C / H) % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* r = static_cast<float4*>(rows);
  const long long n = static_cast<long long>(B) * T * H;
  attention_delta_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out),
      static_cast<const float*>(m), static_cast<const float*>(l), r, B, T, C, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (C / H) {
    case 16:
      return launch_backward<16>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 24:
      return launch_backward<24>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 32:
      return launch_backward<32>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 48:
      return launch_backward<48>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 64:
      return launch_backward<64>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 96:
      return launch_backward<96>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 128:
      return launch_backward<128>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    case 192:
      return launch_backward<192>(qkv, dout, r, dqkv, B, T, C, H, scale2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
