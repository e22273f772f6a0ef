// Timing trial of the gear-value kernel (K3) and the flat-ladder kernel
// (K4): variants of the port's kernels in backuwup_tpu_torch/csrc, built
// and timed by scripts/torch_k3k4_variants.py.  Not part of the port.
//
// K3 variants (bkw_k3_variant): 4-byte groups per thread (4, 8 = the
// port's, 16), plain stores instead of the port's streaming stores
// (__stcs), 32 per-lane copies of the table,
// and the kernel the port had before (16 bytes in, four 16-byte stores at
// a 64-byte stride, a grid-stride loop over at most 4,224 blocks, and a
// byte-at-a-time loop for any input that is not 16-byte aligned), plus
// that store pattern alone on the new grid.
//
// K4 variants (bkw_k4_variant): run lengths 8, 16 (the port's) and 32,
// spans per warp 1 (the port's), 4 and 16 (the carry passed from span to
// span), streaming stores, and the kernel the port had before (one thread
// per position, 32 Horner taps over a shared tile).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr uint32_t kGearSeed = 0x6261636Bu;

__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t h = b + kGearSeed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kStream, typename T>
__device__ __forceinline__ void put(T* p, T v) {
  if (kStream) __stcs(p, v); else *p = v;
}

// ---- K3 ----------------------------------------------------------------

// kLanes: 32 copies of the table, entry v of lane l at 32 v + l
template <int kGroups, bool kStream, bool kLanes>
__global__ void __launch_bounds__(kThreads)
k3_kernel(const uint8_t* __restrict__ b, uint32_t* __restrict__ g,
          long long n) {
  __shared__ uint32_t tab[kLanes ? 256 * 32 : 256];
  if (kLanes) {
    for (int i = threadIdx.x; i < 256 * 32; i += kThreads)
      tab[i] = gear(i >> 5);
  } else {
    tab[threadIdx.x] = gear(threadIdx.x);
  }
  __syncthreads();
  const int lane = kLanes ? (threadIdx.x & 31) : 0;
  const int stride = kLanes ? 32 : 1;
  const uint8_t* end = b + n;
  const uintptr_t start = (uintptr_t)b;
  const unsigned shift = 8u * (unsigned)(start & 3u);
  const uint32_t* aligned = (const uint32_t*)(start & ~(uintptr_t)3u);
  const long long k0 = (long long)blockIdx.x * (kThreads * kGroups)
                       + threadIdx.x;
  uint32_t w[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const uint32_t* p = aligned + k0 + (long long)u * kThreads;
    const uint32_t lo = (const uint8_t*)p < end ? __ldg(p) : 0u;
    const uint32_t hi =
        shift != 0u && (const uint8_t*)(p + 1) < end ? __ldg(p + 1) : 0u;
    w[u] = __funnelshift_r(lo, hi, shift);
  }
  const long long whole = n >> 2;
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const long long k = k0 + (long long)u * kThreads;
    const uint32_t x = w[u];
    const uint4 v = make_uint4(tab[(x & 0xFFu) * stride + lane],
                               tab[((x >> 8) & 0xFFu) * stride + lane],
                               tab[((x >> 16) & 0xFFu) * stride + lane],
                               tab[(x >> 24) * stride + lane]);
    if (k < whole) {
      put<kStream>(reinterpret_cast<uint4*>(g) + k, v);
    } else if (k == whole) {
      const int rest = (int)(n & 3);
      if (rest > 0) g[4 * k] = v.x;
      if (rest > 1) g[4 * k + 1] = v.y;
      if (rest > 2) g[4 * k + 2] = v.z;
    }
  }
}

__device__ __forceinline__ uint4 lookup4(const uint32_t* tab, uint32_t w) {
  return make_uint4(tab[w & 0xFFu], tab[(w >> 8) & 0xFFu],
                    tab[(w >> 16) & 0xFFu], tab[w >> 24]);
}

// the port's kernel before this trial's redesign, verbatim
__global__ void __launch_bounds__(kThreads)
k3_old_kernel(const uint8_t* __restrict__ b, uint32_t* __restrict__ g,
              long long n, long long n_vec) {
  __shared__ uint32_t tab[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) tab[i] = gear(i);
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* b16 = reinterpret_cast<const uint4*>(b);
  uint4* g16 = reinterpret_cast<uint4*>(g);
  for (long long v = tid; v < n_vec; v += stride) {
    const uint4 w = b16[v];
    g16[4 * v + 0] = lookup4(tab, w.x);
    g16[4 * v + 1] = lookup4(tab, w.y);
    g16[4 * v + 2] = lookup4(tab, w.z);
    g16[4 * v + 3] = lookup4(tab, w.w);
  }
  for (long long i = 16 * n_vec + tid; i < n; i += stride) g[i] = tab[b[i]];
}

// the old store pattern alone: 16 aligned bytes in per step, four 16-byte
// stores at a 64-byte stride, two steps per thread, one tile per block
// (n a multiple of 16 and the input 16-byte aligned)
__global__ void __launch_bounds__(kThreads)
k3_stride_kernel(const uint8_t* __restrict__ b, uint32_t* __restrict__ g,
                 long long n) {
  __shared__ uint32_t tab[256];
  tab[threadIdx.x] = gear(threadIdx.x);
  __syncthreads();
  const uint4* b16 = reinterpret_cast<const uint4*>(b);
  uint4* g16 = reinterpret_cast<uint4*>(g);
  const long long v0 = (long long)blockIdx.x * (2 * kThreads) + threadIdx.x;
  uint4 w[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long v = v0 + u * kThreads;
    w[u] = v < n / 16 ? b16[v] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long v = v0 + u * kThreads;
    if (v >= n / 16) break;
    g16[4 * v + 0] = lookup4(tab, w[u].x);
    g16[4 * v + 1] = lookup4(tab, w[u].y);
    g16[4 * v + 2] = lookup4(tab, w[u].z);
    g16[4 * v + 3] = lookup4(tab, w[u].w);
  }
}

template <int kGroups, bool kStream, bool kLanes>
int launch_k3(const void* b, void* g, long long n, cudaStream_t s) {
  const long long per = (long long)kThreads * kGroups * 4;
  k3_kernel<kGroups, kStream, kLanes><<<(unsigned)((n + per - 1) / per),
                                        kThreads, 0, s>>>(
      (const uint8_t*)b, (uint32_t*)g, n);
  return (int)cudaGetLastError();
}

// ---- K4 ----------------------------------------------------------------

template <int R>
__device__ __forceinline__ int slot(int r) {
  return R * r + 4 * ((r * R) >> 5);
}

template <int R, int S, bool kStream>
__global__ void __launch_bounds__(kThreads)
k4_kernel(const uint32_t* __restrict__ g, uint8_t* __restrict__ cl,
          uint8_t* __restrict__ cs, long long n_valid, uint32_t mask_l,
          uint32_t mask_ls) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kSpan = 32 * R;
  constexpr int W = R / 4;  // flag words per thread and mask
  __shared__ __align__(16) uint32_t tiles[kWarps][36 * R];
  const int lane = threadIdx.x & 31;
  uint32_t* tile = tiles[threadIdx.x >> 5];
  long long p0 = (long long)blockIdx.x * (kWarps * S * kSpan)
                 + (long long)(threadIdx.x >> 5) * (S * kSpan);
  const long long e = p0 - 32 + lane;
  uint32_t carry = e >= 0 ? __ldg(g + e) << (31 - lane) : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) carry += __shfl_xor_sync(kAll, carry, o);
#pragma unroll 1
  for (int s = 0; s < S; ++s, p0 += kSpan) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = lane + 32 * k;
      tile[slot<R>(i / R) + i % R] = __ldg(g + p0 + i);
    }
    __syncwarp();
    uint32_t x[R];
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(tile + slot<R>(lane) + 4 * j);
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    }
    __syncwarp();
    uint32_t local = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) local = (local << 1) + x[i];
    uint32_t end = local;
#pragma unroll
    for (int j = 1; j * R < 32; ++j) {
      const uint32_t v = __shfl_up_sync(kAll, local, j);
      if (lane >= j) end += v << (j * R);
    }
    if ((lane + 1) * R < 32) end += carry << ((lane + 1) * R);
    uint32_t h = __shfl_up_sync(kAll, end, 1);
    if (lane == 0) h = carry;
    carry = __shfl_sync(kAll, end, 31);
    uint32_t wl[W], ws[W];
#pragma unroll
    for (int j = 0; j < W; ++j) wl[j] = ws[j] = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      h = (h << 1) + x[i];
      const uint32_t byte = 1u << (8 * (i & 3));
      if ((h & mask_l) == 0u) wl[i >> 2] |= byte;
      if ((h & mask_ls) == 0u) ws[i >> 2] |= byte;
    }
    const long long pos = p0 + (long long)R * lane;
    const long long left = n_valid - pos;
    if (left < R) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const long long nb = left - 4 * j;
        const uint32_t m = nb <= 0 ? 0u : nb >= 4 ? kAll
                                                  : (1u << (8 * (int)nb)) - 1u;
        wl[j] &= m;
        ws[j] &= m;
      }
    }
    if constexpr (R == 8) {
      put<kStream>(reinterpret_cast<uint2*>(cl + pos),
                   make_uint2(wl[0], wl[1]));
      put<kStream>(reinterpret_cast<uint2*>(cs + pos),
                   make_uint2(ws[0], ws[1]));
    } else {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        put<kStream>(reinterpret_cast<uint4*>(cl + pos) + j / 4,
                     make_uint4(wl[j], wl[j + 1], wl[j + 2], wl[j + 3]));
        put<kStream>(reinterpret_cast<uint4*>(cs + pos) + j / 4,
                     make_uint4(ws[j], ws[j + 1], ws[j + 2], ws[j + 3]));
      }
    }
  }
}

// the port's kernel before this trial's redesign, verbatim
__global__ void __launch_bounds__(kThreads)
k4_old_kernel(const uint32_t* __restrict__ g, uint8_t* __restrict__ cl,
              uint8_t* __restrict__ cs, long long n, long long n_valid,
              uint32_t mask_s, uint32_t mask_l) {
  __shared__ uint32_t tile[kThreads + 31];
  const long long p0 = (long long)blockIdx.x * kThreads;
  for (int i = threadIdx.x; i < kThreads + 31; i += kThreads) {
    const long long e = p0 - 31 + i;
    tile[i] = e >= 0 ? g[e] : 0u;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const long long p = p0 + t;
  if (p >= n) return;
  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) h = (h << 1) + tile[t + j];
  const bool l = ((h & mask_l) == 0u) && (p < n_valid);
  const bool s = l && ((h & mask_s) == 0u);
  cl[p] = l ? 1 : 0;
  cs[p] = s ? 1 : 0;
}

template <int R, int S, bool kStream>
int launch_k4(const void* g, void* cl, void* cs, long long n, long long nv,
              uint32_t ms, uint32_t ml, cudaStream_t st) {
  const long long per = (long long)kThreads / 32 * S * 32 * R;
  if (n % per) return (int)cudaErrorInvalidValue;
  k4_kernel<R, S, kStream><<<(unsigned)(n / per), kThreads, 0, st>>>(
      (const uint32_t*)g, (uint8_t*)cl, (uint8_t*)cs, nv, ml, ml | ms);
  return (int)cudaGetLastError();
}

}  // namespace

// 0: groups 8 + __stcs (the port's), 1: 4 + __stcs, 2: 16 + __stcs, 3: 8,
// plain stores, 4: 8 + __stcs, 32 lane tables, 5: the old kernel, 6: the
// old store pattern on the new grid
extern "C" int bkw_k3_variant(int variant, const void* b, void* g,
                              long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch_k3<8, true, false>(b, g, n, s);
    case 1: return launch_k3<4, true, false>(b, g, n, s);
    case 2: return launch_k3<16, true, false>(b, g, n, s);
    case 3: return launch_k3<8, false, false>(b, g, n, s);
    case 4: return launch_k3<8, true, true>(b, g, n, s);
    case 5: {
      const bool aligned = ((uintptr_t)b & 15u) == 0;
      const long long n_vec = aligned ? n / 16 : 0;
      const long long work = n_vec > 0 ? n_vec : n;
      long long blocks = (work + kThreads - 1) / kThreads;
      if (blocks > 132 * 32) blocks = 132 * 32;
      k3_old_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
          (const uint8_t*)b, (uint32_t*)g, n, n_vec);
      return (int)cudaGetLastError();
    }
    case 6: {
      if ((n % 16) || ((uintptr_t)b & 15u)) return (int)cudaErrorInvalidValue;
      const long long per = 2LL * kThreads * 16;
      k3_stride_kernel<<<(unsigned)((n + per - 1) / per), kThreads, 0, s>>>(
          (const uint8_t*)b, (uint32_t*)g, n);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

// 0: run 16, 1 span (the port's), 1: run 8, 2: run 32, 3: 4 spans,
// 4: 16 spans, 5: run 16 + __stcs, 6: the old kernel
extern "C" int bkw_k4_variant(int variant, const void* g, void* cl, void* cs,
                              long long n, long long n_valid,
                              unsigned int mask_s, unsigned int mask_l,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch_k4<16, 1, false>(g, cl, cs, n, n_valid, mask_s,
                                           mask_l, s);
    case 1: return launch_k4<8, 1, false>(g, cl, cs, n, n_valid, mask_s,
                                          mask_l, s);
    case 2: return launch_k4<32, 1, false>(g, cl, cs, n, n_valid, mask_s,
                                           mask_l, s);
    case 3: return launch_k4<16, 4, false>(g, cl, cs, n, n_valid, mask_s,
                                           mask_l, s);
    case 4: return launch_k4<16, 16, false>(g, cl, cs, n, n_valid, mask_s,
                                            mask_l, s);
    case 5: return launch_k4<16, 1, true>(g, cl, cs, n, n_valid, mask_s,
                                          mask_l, s);
    case 6:
      k4_old_kernel<<<(unsigned)(n / kThreads), kThreads, 0, s>>>(
          (const uint32_t*)g, (uint8_t*)cl, (uint8_t*)cs, n, n_valid, mask_s,
          mask_l);
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
