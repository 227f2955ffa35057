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
                          const float* __restrict__ bias, T* __restrict__ y, int s, int c,
                          int groups, int slice_pix, int cache_pix, float n, float eps) {
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
    const float var = fmaxf(gq / n - mean * mean, 0.0f);
    g_mean[g] = mean;
    g_inv[g] = 1.0f / sqrtf(var + eps);
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();
  for (int ch = tid; ch < c; ch += nt) {
    const int g = ch / cpg;
    const float a = g_inv[g] * scale[ch];
    ch_a[ch] = a;
    ch_b[ch] = bias[ch] - g_mean[g] * a;
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
using KernelFn = void (*)(const T*, const float*, const float*, T*, int, int, int, int, int,
                          float, float);

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
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, int act,
                   long long rows, long long s, int c, int groups, int cluster, int threads,
                   int slice_pix, int cache_pix, int smem, float eps, cudaStream_t stream) {
  KernelFn<T> fn;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure<T>(act, rows, s, c, groups, cluster, threads, slice_pix, cache_pix,
                                 smem, stream, &attr, &cfg, &fn);
  if (err != cudaSuccess) return err;
  const float n = static_cast<float>(s) * static_cast<float>(c / groups);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const T*>(x), scale, bias, static_cast<T*>(y),
                           static_cast<int>(s), c, groups, slice_pix, cache_pix, n, eps);
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
// (0 = fp32, 1 = bf16); scale, bias: (c,) fp32. act: 0 none, 1 SiLU, 2 ReLU.
// One cluster of `cluster` blocks of `threads` threads per row; block r takes
// pixels [r * slice_pix, (r + 1) * slice_pix) and holds the first cache_pix of
// them in its `smem` bytes of dynamic shared memory. Returns a cudaError_t
// value (0 on success).
int group_norm_act(const void* x, const void* scale, const void* bias, void* y, int dtype,
                   int act, long long rows, long long s, int c, int groups, int cluster,
                   int threads, int slice_pix, int cache_pix, int smem, float eps, void* stream,
                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  switch (dtype) {
    case 0:
      return launch<float>(x, sc, bi, y, act, rows, s, c, groups, cluster, threads, slice_pix,
                           cache_pix, smem, eps, st);
    case 1:
      return launch<__nv_bfloat16>(x, sc, bi, y, act, rows, s, c, groups, cluster, threads,
                                   slice_pix, cache_pix, smem, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
