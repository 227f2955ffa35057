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

// Copy `rows` rows of kChunks 16-byte chunks, starting at token row0, into a
// shared tile of row stride kStride chunks. Chunks at or past kDataChunks and
// rows at or past T are zero-filled.
template <int kChunks, int kDataChunks, int kStride>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, size_t c3,
                                          int row0, int rows, int T) {
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool valid = row0 + r < T && c < kDataChunks;
    const __nv_bfloat16* from = valid ? src + static_cast<size_t>(row0 + r) * c3 + 8 * c : src;
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
                     int T, int C, float scale2) {
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
cudaError_t launch(const void* qkv, void* out, int B, int T, int C, int H, float scale2,
                   cudaStream_t stream) {
  constexpr int smem = Geometry<D>::kSmemBytes;
  auto kernel = qkv_attention_kernel<D>;
  if constexpr (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                           static_cast<__nv_bfloat16*>(out), T, C, scale2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv: (B, T, 3C) bf16 contiguous, 16-byte aligned; out: (B, T, C) bf16.
// Returns a cudaError_t value (0 on success).
int qkv_attention_bf16(const void* qkv, void* out, int B, int T, int C, int H, float scale2,
                       void* stream, int device) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || C % H != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16:
      return launch<16>(qkv, out, B, T, C, H, scale2, s);
    case 24:
      return launch<24>(qkv, out, B, T, C, H, scale2, s);
    case 32:
      return launch<32>(qkv, out, B, T, C, H, scale2, s);
    case 48:
      return launch<48>(qkv, out, B, T, C, H, scale2, s);
    case 64:
      return launch<64>(qkv, out, B, T, C, H, scale2, s);
    case 96:
      return launch<96>(qkv, out, B, T, C, H, scale2, s);
    case 128:
      return launch<128>(qkv, out, B, T, C, H, scale2, s);
    case 192:
      return launch<192>(qkv, out, B, T, C, H, scale2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
