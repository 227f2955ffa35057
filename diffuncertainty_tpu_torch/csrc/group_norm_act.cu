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
// ReLU) in f32; the cast back to the input type. The affine is (C,) or, for
// member-folded rows (a stacked ensemble, ops/member_fold.py), (M, C): row b
// takes member b / rows_per_member's row of it, as the JAX group_norm_32
// repeats an (M, C) affine over M member-major blocks. The TPU kernel's lane fold
// (f = 128/C) is a layout trick for its 128-lane registers and has no
// counterpart here.
//
// Bound on the H100: memory. The function reads each input value once and
// writes each output value once (2 bytes a value in bf16, 4 in fp32) at
// 3.35 TB/s; it does about 10 f32 operations a value, some 30x below the
// card's ridge. So the design keeps each element in shared memory between its
// two passes instead of reading it from device memory twice.
//
// Design: one thread-block cluster of K blocks (K = 1, 2, 4, 8 or 16) per
// batch element. Block r of the cluster owns the contiguous pixels
// [r*P, (r+1)*P) of its element (whole pixels, so every 16-byte packet
// of a thread holds the same channels at every step). It copies the first
// `cache_pix` of them from device memory into its dynamic shared memory with
// 1-D bulk copies (cp.async.bulk, kChunks copies on kChunks mbarriers, so the
// statistics start on the first chunk while the rest is in flight), sums
// them in f32 from shared memory, and keeps them there: the normalised values
// are computed from shared memory and written with 16-byte stores. An element
// whose slices all fit (`cache_pix == P`, "resident") is read from device
// memory once. The caller sizes blocks to run two or three to an SM, so one
// block's load overlaps another's store; an element that 16 such blocks
// cannot hold ("stream") has the pixels past `cache_pix` read from device
// memory in both passes, the second time from the 50 MB L2.
//
// Statistics: per-thread f32 partials; warp shuffles (when the threads of one
// pixel divide a warp) and then a fixed-order sum over shared memory give the
// block's per-channel sums and sums of squares, and those its per-group ones.
// After cluster.sync() every block reads the K blocks' group arrays through
// distributed shared memory (cluster.map_shared_rank) and adds them in rank
// order 0..K-1, so all blocks of the element form the same statistics, in the
// same order in every run (no atomics). Exchanging G group sums, not C
// channel sums, keeps that traffic at 8*G*K bytes a block. A block arrives on
// the cluster barrier once it has read the others' arrays and waits on it
// before it exits, so no block leaves while another still reads its shared
// memory.
//
// Limits: C % vector == 0 and C <= kMaxChannels; threads (a multiple of 32,
// at most kMaxThreads) cover at least one pixel (C / vector packets); K in
// {1, 2, 4, 8, 16} (16 is a non-portable cluster size); the dynamic shared
// memory is exactly smem_layout(...).total <= kSmemLimit; x and y 16-byte
// aligned. The caller plans K, threads, P and cache_pix
// (ops/cuda_groupnorm.py::cluster_plan) and asks group_norm_act_clusters
// whether that cluster can be scheduled before it first launches it. The
// host functions return a cudaError_t value.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxChannels = 2048;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block: 227 KB
constexpr int kChunks = 4;          // bulk copies (and mbarriers) per cached slice
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

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

// Rows of the block's table of per-channel partials: one per warp where the
// cv packets of a pixel divide a warp (the warp folds its pixels with
// shuffles), else one per pixel of a block step.
__host__ __device__ inline int part_rows(int threads, int cv) {
  return 32 % cv == 0 ? threads / 32 : threads / cv;
}

// Byte offsets in the dynamic shared memory: the cached pixels, the chunks'
// mbarriers, the table of partials (part_rows x c floats), per channel the
// block's sums and sums of squares, later the folded a and b, then per group
// the block's sums and sums of squares (read by the cluster), the mean and
// inv.
struct Layout {
  int bars, part, ch_a, ch_b, g_s, g_q, g_mean, g_inv, total;
};

__host__ __device__ inline Layout smem_layout(int cache_bytes, int threads, int v, int c,
                                              int groups) {
  Layout l;
  l.bars = cache_bytes;
  l.part = l.bars + kChunks * 8;
  l.ch_a = l.part + part_rows(threads, c / v) * c * 4;
  l.ch_b = l.ch_a + c * 4;
  l.g_s = l.ch_b + c * 4;
  l.g_q = l.g_s + groups * 4;
  l.g_mean = l.g_q + groups * 4;
  l.g_inv = l.g_mean + groups * 4;
  l.total = l.g_inv + groups * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// One thread arms the barrier for `bytes` and starts the copy that completes it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
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

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) pairs[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return raw;
}

// SiLU from the hardware exp2 and reciprocal (two MUFU operations a value, a
// few ulp from y / (1 + expf(-y))): at one MUFU result per lane every other
// clock the IEEE division's extra instructions, not memory, would set the pace.
template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kSilu) return __fdividef(y, 1.0f + __expf(-y));
  if (ACT == kRelu) return fmaxf(y, 0.0f);
  return y;
}

// The smallest pixel >= from that a thread at pixel offset poff visits when it
// steps by ppt pixels.
__device__ __forceinline__ int first_pixel(int from, int poff, int ppt) {
  return from + ((poff - from % ppt) % ppt + ppt) % ppt;
}

// Adds packets src[p * cv + slot] for p = p, p + step, ... < end.
template <int V>
__device__ __forceinline__ void accumulate(const uint4* src, int p, int end, int step, int cv,
                                           int slot, float (&s)[V], float (&q)[V]) {
  for (; p + (kUnroll - 1) * step < end; p += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = src[(p + u * step) * cv + slot];
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
  for (; p < end; p += step) {
    float v[V];
    unpack(src[p * cv + slot], v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] += v[j];
      q[j] += v[j] * v[j];
    }
  }
}

// dst[p * cv + slot] = act(src[...] * a + b) for p = p, p + step, ... < end.
template <int V, int ACT>
__device__ __forceinline__ void normalize(const uint4* src, uint4* dst, int p, int end, int step,
                                          int cv, int slot, const float (&a)[V],
                                          const float (&b)[V]) {
  for (; p + (kUnroll - 1) * step < end; p += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = src[(p + u * step) * cv + slot];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[V];
      unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = activate<ACT>(v[j] * a[j] + b[j]);
      dst[(p + u * step) * cv + slot] = pack(v);
    }
  }
  for (; p < end; p += step) {
    float v[V];
    unpack(src[p * cv + slot], v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = activate<ACT>(v[j] * a[j] + b[j]);
    dst[p * cv + slot] = pack(v);
  }
}

// The block's per-channel totals of one partial per thread into out[c], in a
// fixed order. Thread tid holds pixel offset tid / cv and packet slot tid % cv.
template <int V>
__device__ __forceinline__ void block_channel_sums(float (&val)[V], float* part, float* out,
                                                   int c, int cv, bool active) {
  const int tid = threadIdx.x;
  if (32 % cv == 0) {
    // every warp holds 32 / cv whole pixels: fold them with shuffles, then
    // one row of the table per warp
#pragma unroll
    for (int j = 0; j < V; ++j)
      for (int off = 16; off >= cv; off >>= 1) val[j] += __shfl_xor_sync(0xffffffffu, val[j], off);
    const int lane = tid % 32;
    if (lane < cv) {
#pragma unroll
      for (int j = 0; j < V; ++j) part[(tid / 32) * c + lane * V + j] = val[j];
    }
  } else if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) part[(tid / cv) * c + (tid % cv) * V + j] = val[j];
  }
  __syncthreads();
  const int rows = part_rows(blockDim.x, cv);
  for (int ch = tid; ch < c; ch += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += part[r * c + ch];
    out[ch] = acc;
  }
  __syncthreads();
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          float* __restrict__ mean_out, float* __restrict__ var_out,
                          int rows_per_member, int s, int c, int groups, int slice_pix,
                          int cache_pix, float n, float eps) {
  constexpr int V = VecOf<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / k;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cv = c / V;          // 16-byte packets per pixel
  const int ppt = nt / cv;       // pixels one step of the block covers
  const int slot = tid % cv;     // the thread's packet within a pixel: fixed channels
  const int poff = tid / cv;     // the thread's pixel within a step
  const bool active = poff < ppt;
  const int p0 = min(s, rank * slice_pix);
  const int npix = min(s, p0 + slice_pix) - p0;  // pixels of this block
  const int ncache = min(npix, cache_pix);       // of them held in shared memory
  const long long first = (row * s + p0) * static_cast<long long>(cv);
  const uint4* xg = reinterpret_cast<const uint4*>(x) + first;
  uint4* yg = reinterpret_cast<uint4*>(y) + first;

  const Layout l = smem_layout(cache_pix * cv * 16, nt, V, c, groups);
  uint4* xs = reinterpret_cast<uint4*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  float* part = reinterpret_cast<float*>(smem + l.part);
  float* ch_a = reinterpret_cast<float*>(smem + l.ch_a);
  float* ch_b = reinterpret_cast<float*>(smem + l.ch_b);
  float* g_s = reinterpret_cast<float*>(smem + l.g_s);
  float* g_q = reinterpret_cast<float*>(smem + l.g_q);
  float* g_mean = reinterpret_cast<float*>(smem + l.g_mean);
  float* g_inv = reinterpret_cast<float*>(smem + l.g_inv);

  // the cached pixels in kChunks bulk copies, one mbarrier each
  const int chunk_pix = (ncache + kChunks - 1) / kChunks;
  if (tid == 0) {
    for (int i = 0; i < kChunks; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kChunks; ++i) {
      const int a = i * chunk_pix;
      const int e = min(ncache, a + chunk_pix);
      if (e > a)
        bulk_load(xs + a * cv, xg + a * cv, static_cast<uint32_t>((e - a) * cv * 16), &bars[i]);
    }
  }
  __syncthreads();

  // per-thread f32 partials of the thread's V channels: the cached pixels as
  // their chunks land, then the rest from device memory
  float s_[V], q_[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s_[j] = q_[j] = 0.0f;
  if (active) {
    for (int i = 0; i < kChunks; ++i) {
      const int a = i * chunk_pix;
      const int e = min(ncache, a + chunk_pix);
      if (e <= a) break;
      mbar_wait(&bars[i]);
      accumulate<V>(xs, first_pixel(a, poff, ppt), e, ppt, cv, slot, s_, q_);
    }
    accumulate<V>(xg, first_pixel(ncache, poff, ppt), npix, ppt, cv, slot, s_, q_);
  }
  block_channel_sums<V>(s_, part, ch_a, c, cv, active);
  block_channel_sums<V>(q_, part, ch_b, c, cv, active);

  // the block's group sums, then the element's from the K blocks' group sums
  // in rank order (one rank's groups are neighbouring words)
  const int cpg = c / groups;
  for (int g = tid; g < groups; g += nt) {
    float gs = 0.0f, gq = 0.0f;
    for (int j = 0; j < cpg; ++j) {
      gs += ch_a[g * cpg + j];
      gq += ch_b[g * cpg + j];
    }
    g_s[g] = gs;
    g_q[g] = gq;
  }
  cluster.sync();
  for (int g = tid; g < groups; g += nt) {
    float gs = 0.0f, gq = 0.0f;
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      gs += cluster.map_shared_rank(g_s, r)[g];
      gq += cluster.map_shared_rank(g_q, r)[g];
    }
    const float mean = gs / n;
    const float var_raw = gq / n - mean * mean;
    g_mean[g] = mean;
    g_inv[g] = 1.0f / sqrtf(fmaxf(var_raw, 0.0f) + eps);
    if (mean_out != nullptr && rank == 0) {  // under grad: the group statistics
      mean_out[row * groups + g] = mean;
      var_out[row * groups + g] = var_raw;
    }
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();
  // this element's member's row of the affine
  const long long affine_row = (row / rows_per_member) * c;
  for (int ch = tid; ch < c; ch += nt) {
    const int g = ch / cpg;
    const float a = g_inv[g] * scale[affine_row + ch];
    ch_a[ch] = a;
    ch_b[ch] = bias[affine_row + ch] - g_mean[g] * a;
  }
  __syncthreads();

  // y = act(x * a + b) for the thread's fixed channels
  if (active) {
    float a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = ch_a[slot * V + j];
      b[j] = ch_b[slot * V + j];
    }
    normalize<V, ACT>(xs, yg, first_pixel(0, poff, ppt), ncache, ppt, cv, slot, a, b);
    normalize<V, ACT>(xg, yg, first_pixel(ncache, poff, ppt), npix, ppt, cv, slot, a, b);
  }
  cluster_wait();  // no block leaves while another reads its shared memory
}

template <typename T>
using KernelFn = void (*)(const T*, const float*, const float*, T*, float*, float*, int, int, int,
                          int, int, int, float, float);

template <typename T>
KernelFn<T> kernel_for(int act) {
  switch (act) {
    case kNone:
      return group_norm_act_kernel<T, kNone>;
    case kSilu:
      return group_norm_act_kernel<T, kSilu>;
    case kRelu:
      return group_norm_act_kernel<T, kRelu>;
    default:
      return nullptr;
  }
}

// The launch configuration of one cluster per batch element, after checking
// the plan; attributes must outlive the config.
template <typename T>
cudaError_t configure(int act, long long rows, long long s, int c, int groups, int cluster,
                      int threads, int slice_pix, int cache_pix, int smem, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg, KernelFn<T>* kernel) {
  constexpr int V = VecOf<T>::N;
  const KernelFn<T> fn = kernel_for<T>(act);
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
                          cluster == kMaxCluster;
  if (fn == nullptr || rows <= 0 || s <= 0 || s > (1LL << 30) || c <= 0 || c > kMaxChannels ||
      c % V != 0 || groups <= 0 || c % groups != 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || threads < c / V || !cluster_ok || slice_pix <= 0 ||
      static_cast<long long>(slice_pix) * cluster < s ||
      static_cast<long long>(slice_pix) * (c / V) > 0x7fffffffLL || cache_pix < 0 ||
      cache_pix > slice_pix || rows * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long cache_bytes = static_cast<long long>(cache_pix) * c * sizeof(T);
  if (cache_bytes > kSmemLimit ||
      smem != smem_layout(static_cast<int>(cache_bytes), threads, V, c, groups).total ||
      smem > kSmemLimit)
    return cudaErrorInvalidValue;
  // the kernel's attributes, once per kernel and device
  static bool ready[kMaxDevices][3] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device][act]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[device][act] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *kernel = fn;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, float* mean,
                   float* var, int act, long long rows, long long s, int c, int groups,
                   int rows_per_member, int cluster, int threads, int slice_pix, int cache_pix,
                   int smem, float eps, cudaStream_t stream) {
  if (rows_per_member <= 0 || rows % rows_per_member != 0 ||
      (mean == nullptr) != (var == nullptr))
    return cudaErrorInvalidValue;
  KernelFn<T> fn;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure<T>(act, rows, s, c, groups, cluster, threads, slice_pix, cache_pix,
                                 smem, stream, &attr, &cfg, &fn);
  if (err != cudaSuccess) return err;
  const float n = static_cast<float>(s) * static_cast<float>(c / groups);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const T*>(x), scale, bias, static_cast<T*>(y),
                           mean, var, rows_per_member, static_cast<int>(s), c, groups, slice_pix,
                           cache_pix, n, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t clusters(int act, long long s, int c, int groups, int cluster, int threads,
                     int slice_pix, int cache_pix, int smem, int* out) {
  KernelFn<T> fn;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure<T>(act, 1, s, c, groups, cluster, threads, slice_pix, cache_pix,
                                 smem, nullptr, &attr, &cfg, &fn);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}


// ---------------------------------------------------------------------------
// Backward. The TPU kernel has none (the JAX package trains on its plain
// diffuncertainty_tpu/ops/norm.py::group_norm_32); this is the VJP of the
// same math, f32 statistics and the activation in f32 (the port's twin,
// ops/cuda_groupnorm.py::_group_norm_act_math), from the group mean and the
// variance var = E[x^2] - mean^2 (before its clamp) that the forward saved.
// It takes the twin's derivative in the order autograd does (the plain
// version, ops/cuda_groupnorm.py::group_norm_act_backward_reference, equals
// autograd of the twin bit for bit on the CPU), so that a gradient that is
// exactly 0, such as a bias before a group of one channel, comes out as the
// same kind of rounding residue. Per element and group, with
// r = 1/sqrt(max(var, 0) + eps), a = r gamma and b = beta - mean a (the
// forward's fold), z = x a + b and dz = dy act'(z), per channel q = sum dz
// and ga = sum dz x - q mean over the pixels:
//   dbeta = q, dgamma = ga r (summed over each member's rows);
//   g_var = (-g_r / 2) r^3 with g_r = sum_c ga gamma, or 0 where the clamp
//   bit (var < 0);
//   g_mean = sum_c (-q a) - g_var mean - g_var mean;
//   dx = dz a + x g_var / n + x g_var / n + g_mean / n,
// the centred r (gamma dz - mean_g(gamma dz) - xh mean_g(gamma dz xh)) in
// exact arithmetic.
//
// Bound on the H100: by its bytes, memory (x and dy read once and dx written
// once, 2 or 4 bytes a value; some 20 f32 operations a value). Measured, the
// SiLU derivative (its IEEE division, in both passes) and the launch's fixed
// latency at small elements take more time than the bytes do, so the plan
// keeps three blocks an SM for more warps in flight rather than a larger
// cache.
//
// Design: the forward's cluster plan with both inputs cached, in one launch.
// One cluster of K blocks per element, block r owning the contiguous pixels
// [r P, (r+1) P), every thread fixed channels (16-byte packets). Block r
// copies the first `cache_pix` pixels of its slice of x and of dy into its
// dynamic shared memory with the forward's bulk copies (kChunks chunks, each
// chunk of both tensors on one mbarrier). Pass one sums dz and dz x per
// channel in f32 as the chunks land (shuffles, then a fixed-order table, as
// the forward), the pixels past the cache from device memory ("stream", as
// the forward's mode of that name); after cluster.sync() every block adds the
// K blocks' channel sums in rank order through distributed shared memory, so
// all blocks hold the element's sums, and rank 0 writes the row's dgamma and
// dbeta to (rows, C) partials. The group terms follow in a fixed order. Pass
// two reads x and dy from shared memory again (the streamed pixels from
// device memory, where L2 still holds them) and writes dx. So a resident
// element's x and dy cross device memory once.
//
// dscale and dbias in the same launch: after its row's partials, rank 0 of
// each cluster counts its row on its member's counter (the only atomic);
// the cluster that counts the member's last row adds the member's rows of the
// partials in row order, writes that member's dgamma and dbeta, and sets the
// counter back to 0 for the next launch. No sum is taken with atomics, so two
// runs give the same bits. The counters (one unsigned a member) are the
// caller's, zero before the launch, and not shared with a launch that may run
// at the same time.

// Byte offsets in the backward's dynamic shared memory: the cached pixels of
// x, then of dy, the chunks' mbarriers, the table of partials (part_rows x c
// floats); per channel the block's sums of dz and dz x (read by the cluster),
// the element's, gamma and beta; per group the mean, the variance, r, and the
// two coefficients of pass two.
struct BwdLayout {
  int dys, bars, part, s1, s2, e1, e2, gam, bet, mean, var, rstd, ga, gb, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int cache_bytes, int threads, int v, int c,
                                                int groups) {
  BwdLayout l;
  l.dys = cache_bytes;
  l.bars = l.dys + cache_bytes;
  l.part = l.bars + kChunks * 8;
  l.s1 = l.part + part_rows(threads, c / v) * c * 4;
  l.s2 = l.s1 + c * 4;
  l.e1 = l.s2 + c * 4;
  l.e2 = l.e1 + c * 4;
  l.gam = l.e2 + c * 4;
  l.bet = l.gam + c * 4;
  l.mean = l.bet + c * 4;
  l.var = l.mean + groups * 4;
  l.rstd = l.var + groups * 4;
  l.ga = l.rstd + groups * 4;
  l.gb = l.ga + groups * 4;
  l.total = l.gb + groups * 4;
  return l;
}

// Blocks of at most this many threads are compiled to run three to an SM (at
// most 85 registers a thread); wider ones (fp32 past 1024 channels) one.
constexpr int kBwdNarrow = 256;

// One thread arms the barrier for `bytes` in all, for the copies that follow.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy of `bytes` that completes on an armed barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// act'(z) in f32 (SiLU: sigma(z) (1 + z (1 - sigma(z))); ReLU: z > 0; none: 1).
template <int ACT>
__device__ __forceinline__ float activate_grad(float z) {
  if (ACT == kSilu) {
    const float sg = 1.0f / (1.0f + __expf(-z));
    return sg * (1.0f + z * (1.0f - sg));
  }
  if (ACT == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  return 1.0f;
}

// Adds dz and dz x of packets p, p + step, ... < end (in that order) to a1 and
// a2, with dz = dy act'(x fa + fb).
template <int V, int ACT>
__device__ __forceinline__ void accumulate_grad(const uint4* xsrc, const uint4* gsrc, int p,
                                                int end, int step, int cv, int slot,
                                                const float (&fa)[V], const float (&fb)[V],
                                                float (&a1)[V], float (&a2)[V]) {
  for (; p < end; p += step) {
    float xv[V], gv[V];
    unpack(xsrc[p * cv + slot], xv);
    unpack(gsrc[p * cv + slot], gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = gv[j] * activate_grad<ACT>(xv[j] * fa[j] + fb[j]);
      a1[j] += dz;
      a2[j] += dz * xv[j];
    }
  }
}

// dst[p * cv + slot] = dz a + x g_var / n + x g_var / n + g_mean / n for
// packets p, p + step, ... < end (cb = g_var / n, ca = g_mean / n).
template <int V, int ACT>
__device__ __forceinline__ void input_grad(const uint4* xsrc, const uint4* gsrc, uint4* dst, int p,
                                           int end, int step, int cv, int slot,
                                           const float (&fa)[V], const float (&fb)[V],
                                           const float (&ca)[V], const float (&cb)[V]) {
  for (; p < end; p += step) {
    float xv[V], gv[V];
    unpack(xsrc[p * cv + slot], xv);
    unpack(gsrc[p * cv + slot], gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dz = gv[j] * activate_grad<ACT>(xv[j] * fa[j] + fb[j]);
      const float sq = cb[j] * xv[j];
      xv[j] = dz * fa[j] + sq + sq + ca[j];
    }
    dst[p * cv + slot] = pack(xv);
  }
}

template <typename T, int ACT, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, MAX_THREADS <= kBwdNarrow ? 3 : 1)
    group_norm_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              const float* __restrict__ mean, const float* __restrict__ var,
                              T* __restrict__ dx, float* __restrict__ dscale,
                              float* __restrict__ dbias, float* __restrict__ part_dgamma,
                              float* __restrict__ part_dbeta, unsigned* __restrict__ counters,
                              int rows_per_member, int s, int c, int groups, int slice_pix,
                              int cache_pix, float n, float eps) {
  constexpr int V = VecOf<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / k;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cv = c / V;
  const int ppt = nt / cv;
  const int slot = tid % cv;
  const int poff = tid / cv;
  const bool active = poff < ppt;
  const int p0 = min(s, rank * slice_pix);
  const int npix = min(s, p0 + slice_pix) - p0;
  const int ncache = min(npix, cache_pix);
  const long long first = (row * s + p0) * static_cast<long long>(cv);
  const uint4* xg = reinterpret_cast<const uint4*>(x) + first;
  const uint4* gg = reinterpret_cast<const uint4*>(dy) + first;
  uint4* dg = reinterpret_cast<uint4*>(dx) + first;

  const BwdLayout l = bwd_layout(cache_pix * cv * 16, nt, V, c, groups);
  uint4* xs = reinterpret_cast<uint4*>(smem);
  uint4* gs = reinterpret_cast<uint4*>(smem + l.dys);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  float* part = reinterpret_cast<float*>(smem + l.part);
  float* s1 = reinterpret_cast<float*>(smem + l.s1);
  float* s2 = reinterpret_cast<float*>(smem + l.s2);
  float* e1 = reinterpret_cast<float*>(smem + l.e1);
  float* e2 = reinterpret_cast<float*>(smem + l.e2);
  float* gam = reinterpret_cast<float*>(smem + l.gam);
  float* bet = reinterpret_cast<float*>(smem + l.bet);
  float* g_mean = reinterpret_cast<float*>(smem + l.mean);
  float* g_var = reinterpret_cast<float*>(smem + l.var);
  float* g_rstd = reinterpret_cast<float*>(smem + l.rstd);
  float* g_a = reinterpret_cast<float*>(smem + l.ga);
  float* g_b = reinterpret_cast<float*>(smem + l.gb);

  // the cached pixels of x and dy in kChunks pairs of bulk copies, one
  // mbarrier a pair
  const int chunk_pix = (ncache + kChunks - 1) / kChunks;
  if (tid == 0) {
    for (int i = 0; i < kChunks; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kChunks; ++i) {
      const int a = i * chunk_pix;
      const int e = min(ncache, a + chunk_pix);
      if (e > a) {
        const uint32_t bytes = static_cast<uint32_t>((e - a) * cv * 16);
        mbar_expect(&bars[i], 2 * bytes);
        bulk_copy(xs + a * cv, xg + a * cv, bytes, &bars[i]);
        bulk_copy(gs + a * cv, gg + a * cv, bytes, &bars[i]);
      }
    }
  }
  const long long member = row / rows_per_member;
  const long long affine_row = member * c;
  for (int ch = tid; ch < c; ch += nt) {
    gam[ch] = scale[affine_row + ch];
    bet[ch] = bias[affine_row + ch];
  }
  for (int g = tid; g < groups; g += nt) {
    g_mean[g] = mean[row * groups + g];
    g_var[g] = var[row * groups + g];
    g_rstd[g] = 1.0f / sqrtf(fmaxf(g_var[g], 0.0f) + eps);  // the forward's, bit for bit
  }
  __syncthreads();

  const int cpg = c / groups;
  float fa[V], fb[V];  // the forward's fold: z = x a + b
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = slot * V + j;
    fa[j] = g_rstd[ch / cpg] * gam[ch];
    fb[j] = bet[ch] - g_mean[ch / cpg] * fa[j];
  }

  // pass one: per-thread sums of dz and dz x over the block's pixels in
  // order: the cached ones as their chunks land, then the rest from device
  // memory
  float a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.0f;
  if (active) {
    for (int i = 0; i < kChunks; ++i) {
      const int a = i * chunk_pix;
      const int e = min(ncache, a + chunk_pix);
      if (e <= a) break;
      mbar_wait(&bars[i]);
      accumulate_grad<V, ACT>(xs, gs, first_pixel(a, poff, ppt), e, ppt, cv, slot, fa, fb, a1,
                              a2);
    }
    accumulate_grad<V, ACT>(xg, gg, first_pixel(ncache, poff, ppt), npix, ppt, cv, slot, fa, fb,
                            a1, a2);
  }
  block_channel_sums<V>(a1, part, s1, c, cv, active);
  block_channel_sums<V>(a2, part, s2, c, cv, active);

  // the element's channel sums from the K blocks' in rank order
  cluster.sync();
  for (int ch = tid; ch < c; ch += nt) {
    float q = 0.0f, pp = 0.0f;
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      q += cluster.map_shared_rank(s1, r)[ch];
      pp += cluster.map_shared_rank(s2, r)[ch];
    }
    e1[ch] = q;
    e2[ch] = pp + (-q) * g_mean[ch / cpg];  // ga
    if (rank == 0) {
      part_dgamma[row * c + ch] = e2[ch] * g_rstd[ch / cpg];
      part_dbeta[row * c + ch] = q;
    }
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();
  for (int g = tid; g < groups; g += nt) {
    const float r = g_rstd[g];
    float gr = 0.0f, gm = 0.0f;
    for (int j = 0; j < cpg; ++j) {
      const int ch = g * cpg + j;
      gr += e2[ch] * gam[ch];
      gm += -e1[ch] * (r * gam[ch]);
    }
    const float gv = g_var[g] < 0.0f ? 0.0f : (-0.5f * gr) * (r * r * r);
    gm = gm + (-gv) * g_mean[g] + (-gv) * g_mean[g];
    g_a[g] = gm / n;
    g_b[g] = gv / n;
  }
  __syncthreads();

  // pass two: dx = dz a + x g_var / n + x g_var / n + g_mean / n
  if (active) {
    float ca[V], cb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (slot * V + j) / cpg;
      ca[j] = g_a[g];
      cb[j] = g_b[g];
    }
    input_grad<V, ACT>(xs, gs, dg, first_pixel(0, poff, ppt), ncache, ppt, cv, slot, fa, fb, ca,
                       cb);
    input_grad<V, ACT>(xg, gg, dg, first_pixel(ncache, poff, ppt), npix, ppt, cv, slot, fa, fb,
                       ca, cb);
  }

  // dscale and dbias: the cluster that counts its member's last row adds the
  // member's partials in row order
  if (rank == 0) {
    __threadfence();  // this row's partials, before its count
    __syncthreads();
    unsigned counted = 0;
    if (tid == 0) {
      counted = atomicAdd(&counters[member], 1u) + 1u;
      __threadfence();  // the other rows' partials, after their counts
    }
    if (__syncthreads_or(counted == static_cast<unsigned>(rows_per_member))) {
      const long long r0 = member * rows_per_member;
      for (int ch = tid; ch < c; ch += nt) {
        float ds = 0.0f, db = 0.0f;
#pragma unroll 4
        for (long long r = r0; r < r0 + rows_per_member; ++r) {
          ds += __ldcg(&part_dgamma[r * c + ch]);
          db += __ldcg(&part_dbeta[r * c + ch]);
        }
        dscale[affine_row + ch] = ds;
        dbias[affine_row + ch] = db;
      }
      if (tid == 0) counters[member] = 0u;  // for the next launch
    }
  }
  cluster_wait();  // no block leaves while another reads its shared memory
}

template <typename T>
using BwdKernelFn = void (*)(const T*, const T*, const float*, const float*, const float*,
                             const float*, T*, float*, float*, float*, float*, unsigned*, int, int,
                             int, int, int, int, float, float);

template <typename T, int MAX_THREADS>
BwdKernelFn<T> bwd_kernel_for(int act) {
  switch (act) {
    case kNone:
      return group_norm_act_bwd_kernel<T, kNone, MAX_THREADS>;
    case kSilu:
      return group_norm_act_bwd_kernel<T, kSilu, MAX_THREADS>;
    case kRelu:
      return group_norm_act_bwd_kernel<T, kRelu, MAX_THREADS>;
    default:
      return nullptr;
  }
}

// The backward's launch configuration (one cluster per element), after
// checking the plan as configure does; attributes must outlive the config.
template <typename T>
cudaError_t configure_bwd(int act, long long rows, long long s, int c, int groups, int cluster,
                          int threads, int slice_pix, int cache_pix, int smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                          BwdKernelFn<T>* kernel) {
  constexpr int V = VecOf<T>::N;
  const bool wide = threads > kBwdNarrow;
  const BwdKernelFn<T> fn =
      wide ? bwd_kernel_for<T, kMaxThreads>(act) : bwd_kernel_for<T, kBwdNarrow>(act);
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
                          cluster == kMaxCluster;
  if (fn == nullptr || rows <= 0 || s <= 0 || s > (1LL << 30) || c <= 0 || c > kMaxChannels ||
      c % V != 0 || groups <= 0 || c % groups != 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || threads < c / V || !cluster_ok || slice_pix <= 0 ||
      static_cast<long long>(slice_pix) * cluster < s ||
      static_cast<long long>(slice_pix) * (c / V) > 0x7fffffffLL || cache_pix < 0 ||
      cache_pix > slice_pix || rows * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long cache_bytes = static_cast<long long>(cache_pix) * c * sizeof(T);
  if (2 * cache_bytes > kSmemLimit ||
      smem != bwd_layout(static_cast<int>(cache_bytes), threads, V, c, groups).total ||
      smem > kSmemLimit)
    return cudaErrorInvalidValue;
  static bool ready[kMaxDevices][3][2] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device][act][wide]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[device][act][wide] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *kernel = fn;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale, const float* bias,
                       const float* mean, const float* var, void* dx, float* grads,
                       unsigned* counters, int act, long long rows, long long s, int c,
                       int groups, int rows_per_member, int cluster, int threads, int slice_pix,
                       int cache_pix, int smem, float eps, cudaStream_t stream) {
  if (rows_per_member <= 0 || rows % rows_per_member != 0) return cudaErrorInvalidValue;
  BwdKernelFn<T> fn;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure_bwd<T>(act, rows, s, c, groups, cluster, threads, slice_pix,
                                     cache_pix, smem, stream, &attr, &cfg, &fn);
  if (err != cudaSuccess) return err;
  const float n = static_cast<float>(s) * static_cast<float>(c / groups);
  // grads: dscale, dbias ((members, c) each), then the rows' partials of each
  const long long members = rows / rows_per_member;
  float* dscale = grads;
  float* dbias = dscale + members * c;
  float* part_dgamma = dbias + members * c;
  float* part_dbeta = part_dgamma + rows * c;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const T*>(x), static_cast<const T*>(dy), scale,
                           bias, mean, var, static_cast<T*>(dx), dscale, dbias, part_dgamma,
                           part_dbeta, counters, rows_per_member, static_cast<int>(s), c, groups,
                           slice_pix, cache_pix, n, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t clusters_bwd(int act, long long s, int c, int groups, int cluster, int threads,
                         int slice_pix, int cache_pix, int smem, int* out) {
  BwdKernelFn<T> fn;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure_bwd<T>(act, 1, s, c, groups, cluster, threads, slice_pix,
                                     cache_pix, smem, nullptr, &attr, &cfg, &fn);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

}  // namespace

extern "C" {

// How many clusters of the planned shape can be active on the device at once
// (cudaOccupancyMaxActiveClusters), into *out. Same plan arguments as
// group_norm_act. Returns a cudaError_t value (0 on success).
int group_norm_act_clusters(int dtype, int act, long long s, int c, int groups, int cluster,
                            int threads, int slice_pix, int cache_pix, int smem, int device,
                            int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return clusters<float>(act, s, c, groups, cluster, threads, slice_pix, cache_pix, smem,
                             out);
    case 1:
      return clusters<__nv_bfloat16>(act, s, c, groups, cluster, threads, slice_pix, cache_pix,
                                     smem, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, y: (rows, s, c) contiguous, 16-byte aligned, of the type named by dtype
// (0 = fp32, 1 = bf16); scale, bias: (rows / rows_per_member, c) fp32, row b of
// x taking row b / rows_per_member of the affine (rows_per_member = rows for a
// (c,) affine; rows * cluster < 2^31, so an int holds it). act: 0 none, 1 SiLU,
// 2 ReLU. mean, var: (rows, groups) f32, the group mean and the variance
// E[x^2] - mean^2 before its clamp at 0, written when not null (the autograd
// forward), else not touched.
// One cluster of `cluster` blocks of `threads` threads per row; block r takes
// pixels [r * slice_pix, (r + 1) * slice_pix) and holds the first cache_pix of
// them in its `smem` bytes of dynamic shared memory. Returns a cudaError_t
// value (0 on success).
int group_norm_act(const void* x, const void* scale, const void* bias, void* y, void* mean,
                   void* var, int dtype, int act, long long rows, long long s, int c,
                   int groups, int rows_per_member, int cluster, int threads, int slice_pix,
                   int cache_pix, int smem, float eps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* mu = static_cast<float*>(mean);
  float* va = static_cast<float*>(var);
  switch (dtype) {
    case 0:
      return launch<float>(x, sc, bi, y, mu, va, act, rows, s, c, groups, rows_per_member,
                           cluster, threads, slice_pix, cache_pix, smem, eps, st);
    case 1:
      return launch<__nv_bfloat16>(x, sc, bi, y, mu, va, act, rows, s, c, groups,
                                   rows_per_member, cluster, threads, slice_pix, cache_pix, smem,
                                   eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

extern "C" {

// How many clusters of the backward's planned shape can be active at once,
// into *out. Same plan arguments as group_norm_act_backward.
int group_norm_act_backward_clusters(int dtype, int act, long long s, int c, int groups,
                                     int cluster, int threads, int slice_pix, int cache_pix,
                                     int smem, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0:
      return clusters_bwd<float>(act, s, c, groups, cluster, threads, slice_pix, cache_pix, smem,
                                 out);
    case 1:
      return clusters_bwd<__nv_bfloat16>(act, s, c, groups, cluster, threads, slice_pix,
                                         cache_pix, smem, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward, one launch: dx (the type of x) from x and dy = dL/dy ((rows,
// s, c), contiguous, 16-byte aligned), the affine as group_norm_act takes it
// and the forward's mean and var (rows, groups) f32; grads: (2 * members + 2
// * rows, c) f32 with members = rows / rows_per_member: dscale and dbias
// (members, c) each, written, then each row's share of both (scratch);
// counters: members unsigned, 0 on entry and on return, used by no other
// launch at the same time. One cluster of `cluster` blocks of `threads`
// threads per row, block r taking pixels [r * slice_pix, (r + 1) * slice_pix)
// and holding the first cache_pix of them of x and dy in its `smem` bytes of
// dynamic shared memory. Returns a cudaError_t value.
int group_norm_act_backward(const void* x, const void* dy, const void* scale, const void* bias,
                            const void* mean, const void* var, void* dx, void* grads,
                            void* counters, int dtype, int act, long long rows, long long s,
                            int c, int groups, int rows_per_member, int cluster, int threads,
                            int slice_pix, int cache_pix, int smem, float eps, void* stream,
                            int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* va = static_cast<const float*>(var);
  float* gr = static_cast<float*>(grads);
  unsigned* cnt = static_cast<unsigned*>(counters);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, dy, sc, bi, mu, va, dx, gr, cnt, act, rows, s, c, groups,
                               rows_per_member, cluster, threads, slice_pix, cache_pix, smem,
                               eps, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, dy, sc, bi, mu, va, dx, gr, cnt, act, rows, s, c,
                                       groups, rows_per_member, cluster, threads, slice_pix,
                                       cache_pix, smem, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
