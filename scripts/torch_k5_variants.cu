// Timing trial of the dedup table's probe and migration (K5), built and
// timed beside the port's kernels by scripts/torch_k5_variants.py:
//  - the probe and the migration round the port had before their redesign
//    (one thread per query or old slot, one slot per dependent load, a
//    64-bit % per step; a growth as rounds of three launches and a memset,
//    with a host read of two flags after each);
//  - the group probe of csrc/dedup_probe.cu with 8 lanes a query, and
//    with windows aligned in memory (4 or 8 lanes);
//  - one thread per query walking kWide slots per round trip;
//  - the port's migration kernel with a %globaltimer stamp at each grid
//    barrier.
// Not part of the port.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool eq4(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

__device__ __forceinline__ bool zero4(uint4 a) {
  return (a.x | a.y | a.z | a.w) == 0u;
}

__device__ __forceinline__ long long walk(const uint4* keys, long long base,
                                          uint32_t cap, uint4 key,
                                          int max_probes, bool match,
                                          bool* hit) {
  const unsigned long long start = key.y % cap;
  for (int p = 0; p < max_probes; ++p) {
    const long long idx = (long long)((start + (unsigned)p) % cap);
    const uint4 k = keys[base + idx];
    if (match && eq4(k, key)) {
      *hit = true;
      return idx;
    }
    if (zero4(k)) {
      *hit = false;
      return idx;
    }
  }
  *hit = false;
  return -1;
}

__global__ void __launch_bounds__(kThreads)
probe_before(const uint4* __restrict__ keys, const uint32_t* __restrict__ vals,
             const uint32_t* __restrict__ q, long long n, uint32_t D,
             uint32_t cap, int max_probes, uint32_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* r = q + 4 * i;
  const uint4 key = make_uint4(r[0], r[1], r[2], r[3]);
  uint32_t f = 0;
  if (!zero4(key)) {
    const long long base = (long long)(key.x % D) * cap;
    bool hit;
    const long long s = walk(keys, base, cap, key, max_probes, true, &hit);
    if (hit) f = vals[base + s] + 1u;
  }
  found[i] = f;
}

__global__ void __launch_bounds__(kThreads)
migrate_probe_before(const uint4* __restrict__ ok, long long n_old,
                     uint32_t old_cap, const uint4* __restrict__ nk,
                     uint32_t new_cap, int max_probes,
                     uint8_t* __restrict__ pending,
                     long long* __restrict__ gslot, int* __restrict__ claim,
                     int* __restrict__ flags) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_old || !(pending[j] & 1)) return;
  const uint4 key = ok[j];
  const long long base = (j / old_cap) * (long long)new_cap;
  bool hit;
  const long long s = walk(nk, base, new_cap, key, max_probes, false, &hit);
  if (s < 0) {
    pending[j] = 1;
    flags[1] = 1;
    return;
  }
  pending[j] = 3;
  gslot[j] = base + s;
  atomicMax(&claim[base + s], (int)j);
}

__global__ void __launch_bounds__(kThreads)
migrate_write_before(const uint4* __restrict__ ok,
                     const uint32_t* __restrict__ ov, long long n_old,
                     uint4* __restrict__ nk, uint32_t* __restrict__ nv,
                     const uint8_t* __restrict__ pending,
                     const long long* __restrict__ gslot,
                     const int* __restrict__ claim) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_old || pending[j] != 3) return;
  const long long g = gslot[j];
  if (claim[g] != (int)j) return;
  nk[g] = ok[j];
  nv[g] = ov[j];
}

__global__ void __launch_bounds__(kThreads)
migrate_race_before(const uint4* __restrict__ ok, long long n_old,
                    const uint4* __restrict__ nk,
                    uint8_t* __restrict__ pending,
                    const long long* __restrict__ gslot,
                    int* __restrict__ claim, int* __restrict__ flags) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_old) return;
  uint8_t st = pending[j];
  if (st & 2) {
    const long long g = gslot[j];
    st = eq4(nk[g], ok[j]) ? 0 : 1;
    claim[g] = -1;
    pending[j] = st;
  }
  if (st & 1) flags[0] = 1;
}

inline unsigned grid(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int bkw_probe_before(const void* keys, const void* vals,
                                const void* q, long long n, unsigned int D,
                                unsigned int cap, int max_probes, void* found,
                                void* stream) {
  probe_before<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint32_t*)q, n, D,
      cap, max_probes, (uint32_t*)found);
  return (int)cudaGetLastError();
}

extern "C" int bkw_migrate_round_before(const void* ok, const void* ov,
                                        long long n_old, unsigned int old_cap,
                                        void* nk, void* nv,
                                        unsigned int new_cap, int max_probes,
                                        void* pending, void* gslot,
                                        void* claim, void* flags,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  migrate_probe_before<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, n_old, old_cap, (const uint4*)nk, new_cap,
      max_probes, (uint8_t*)pending, (long long*)gslot, (int*)claim,
      (int*)flags);
  migrate_write_before<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, (const uint32_t*)ov, n_old, (uint4*)nk,
      (uint32_t*)nv, (const uint8_t*)pending, (const long long*)gslot,
      (const int*)claim);
  migrate_race_before<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, n_old, (const uint4*)nk, (uint8_t*)pending,
      (const long long*)gslot, (int*)claim, (int*)flags);
  return (int)cudaGetLastError();
}

// The random accesses of a probe whose walks all end at their first slot
// (one shard): each query's start-slot key row, and every other query's
// value, one thread per query.
__global__ void __launch_bounds__(kThreads)
gather_floor(const uint4* __restrict__ keys, const uint32_t* __restrict__ vals,
             const uint4* __restrict__ q, long long n, uint32_t cap,
             uint32_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = __ldg(q + i).y % cap;
  const uint4 k = __ldg(keys + s);
  found[i] = k.x ^ ((i & 1) ? __ldg(vals + s) : 0u);
}

extern "C" int bkw_gather_floor(const void* keys, const void* vals,
                                const void* q, long long n, unsigned int cap,
                                void* found, void* stream) {
  gather_floor<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint4*)q, n, cap,
      (uint32_t*)found);
  return (int)cudaGetLastError();
}

// --- variants of the port's redesigned kernels ------------------------------

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t wrap(uint32_t x, uint32_t cap,
                                         uint32_t step) {
  if (x < cap) return x;
  return cap >= step ? x - cap : x % cap;
}

// The port's group probe with G lanes a query; with Align the windows are
// G-slot aligned in memory: lane g of window w holds walk position
// w * G + g - off, off being the start slot's place in its aligned block,
// and lanes before the start (window 0 only) take no part.
template <int G, bool Align>
__global__ void __launch_bounds__(kThreads)
probe_group(const uint4* __restrict__ keys, const uint32_t* __restrict__ vals,
            const uint4* __restrict__ q, long long n, uint32_t D,
            uint32_t cap, int max_probes, uint32_t* __restrict__ found) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int first_lane = lane & ~(G - 1);
  const int g = lane - first_lane;
  const unsigned mask = ((1u << G) - 1u) << first_lane;
  const uint4 key = __ldg(q + i);
  if (zero4(key)) {
    if (g == 0) found[i] = 0;
    return;
  }
  const long long base = (long long)(key.x % D) * cap;
  const uint32_t start = key.y % cap;
  const int off = Align ? (int)((base + start) % G) : 0;
  int p = g - off;
  uint32_t idx = p < 0 ? start : wrap(start + (uint32_t)p, cap, G);
  int writer = 0;
  uint32_t f = 0;
  for (int p0 = -off; p0 < max_probes; p0 += G) {
    const uint4 k = __ldg(keys + base + idx);
    const bool live = p >= 0 && p < max_probes;
    const bool match = live && eq4(k, key);
    const unsigned term =
        __ballot_sync(mask, match || (live && zero4(k))) >> first_lane;
    if (term != 0u) {
      writer = __ffs(term) - 1;
      if (g == writer && match) f = __ldg(vals + base + idx) + 1u;
      break;
    }
    idx = p < 0 ? wrap(start + (uint32_t)(p + G), cap, G)
                : wrap(idx + G, cap, G);
    p += G;
  }
  if (g == writer) found[i] = f;
}

// The port's kWide walk (csrc/dedup_probe.cu walk_wide), loads through L2
// as there, or through L1 (kCg false) where the table is read only.
constexpr int kWide = 4;

template <bool kMatch, bool kCg>
__device__ __forceinline__ long long walk_wide(const uint4* keys,
                                               long long base, uint32_t cap,
                                               uint4 key, int max_probes,
                                               bool* hit) {
  uint32_t idx = key.y % cap;
  for (int p0 = 0; p0 < max_probes; p0 += kWide) {
    uint4 k[kWide];
    uint32_t at[kWide];
#pragma unroll
    for (int j = 0; j < kWide; ++j) {
      at[j] = idx;
      k[j] = kCg ? __ldcg(keys + base + idx) : __ldg(keys + base + idx);
      idx = wrap(idx + 1, cap, 1);
    }
#pragma unroll
    for (int j = 0; j < kWide; ++j) {
      if (p0 + j >= max_probes) break;
      if (kMatch && eq4(k[j], key)) {
        *hit = true;
        return at[j];
      }
      if (zero4(k[j])) {
        *hit = false;
        return at[j];
      }
    }
  }
  *hit = false;
  return -1;
}

// One thread per query over the kWide walk: a uint4 query load, the value
// read at a hit.
__global__ void __launch_bounds__(kThreads)
probe_one_wide(const uint4* __restrict__ keys,
               const uint32_t* __restrict__ vals, const uint4* __restrict__ q,
               long long n, uint32_t D, uint32_t cap, int max_probes,
               uint32_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 key = __ldg(q + i);
  uint32_t f = 0;
  if (!zero4(key)) {
    const long long base = (long long)(key.x % D) * cap;
    bool hit;
    const long long s =
        walk_wide<true, false>(keys, base, cap, key, max_probes, &hit);
    if (hit) f = __ldg(vals + base + s) + 1u;
  }
  found[i] = f;
}

// csrc/dedup_probe.cu migrate_kernel with a %globaltimer stamp at each
// grid barrier: ctl[8...] as u64, one after each round's walk and claim,
// one after its resolution, and one after the claim sweep.
#define TRACE(k)                                                   \
  if (first == 0 && (k) < 56) {                                    \
    unsigned long long t_;                                         \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
    ((unsigned long long*)(ctl + 8))[k] = t_;                      \
  }

__global__ void __launch_bounds__(kThreads)
migrate_traced(const uint4* __restrict__ ok, const uint32_t* __restrict__ ov,
               long long n_old, uint32_t old_cap, uint4* nk, uint32_t* nv,
               uint32_t new_cap, long long n_new, int max_probes,
               int* __restrict__ gslot, int* lists, int* claim, int* ctl) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_next, s_stuck;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  const long long full = n_old / stride, rest = n_old - full * stride;
  const long long seg = blockIdx.x * full * kThreads +
                        min(rest, (long long)blockIdx.x * kThreads);
  int n_cur = 0;
  TRACE(0);
  for (int r = 0;; ++r) {
    const int* list = lists + (r & 1) * n_old + seg;
    int* next = lists + ((r + 1) & 1) * n_old + seg;
    if (first == 0) ctl[r & 1] = 0;
    if (threadIdx.x == 0) s_next = s_stuck = 0;
    if (r == 0) {
      for (long long j = first; j < n_old; j += stride) {
        const uint4 key = __ldg(ok + j);
        int g = -2;
        if (!zero4(key)) {
          g = (int)((j / old_cap) * (long long)new_cap + key.y % new_cap);
          atomicMax(&claim[g], (int)j);
        }
        gslot[j] = g;
      }
    } else {
      for (int t = threadIdx.x; t < n_cur; t += kThreads) {
        const long long j = __ldcg(list + t);
        const long long base = (j / old_cap) * (long long)new_cap;
        bool hit;
        const long long s = walk_wide<false, true>(
            nk, base, new_cap, __ldg(ok + j), max_probes, &hit);
        int g = -1;
        if (s >= 0) {
          g = (int)(base + s);
          atomicMax(&claim[g], (int)j);
        }
        gslot[j] = g;
      }
    }
    grid.sync();
    TRACE(1 + 2 * r);
    const long long span = r == 0 ? n_old : n_cur;
    const long long from = r == 0 ? first - lane : threadIdx.x - lane;
    const long long step = r == 0 ? stride : kThreads;
    for (long long t0 = from; t0 < span; t0 += step) {
      const long long t = t0 + lane;
      long long j = -1;
      bool lost = false;
      if (t < span) {
        j = r == 0 ? t : __ldcg(list + t);
        const int g = gslot[j];
        if (g == -1) {
          s_stuck = 1;
        } else if (g >= 0) {
          const int w = __ldcg(claim + g);
          const uint4 key = __ldg(ok + j);
          bool won = w == (int)j;
          if (won) {
            nk[g] = key;
            nv[g] = __ldg(ov + j);
          } else {
            won = eq4(__ldg(ok + w), key);
          }
          lost = !won;
        }
      }
      const unsigned losers = __ballot_sync(0xffffffffu, lost);
      if (losers != 0u) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_next, __popc(losers));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (lost) next[at + __popc(losers & ((1u << lane) - 1u))] = (int)j;
      }
    }
    __syncthreads();
    n_cur = s_next;
    if (threadIdx.x == 0 && (n_cur != 0 || s_stuck != 0))
      atomicOr(ctl + (r & 1), (n_cur != 0 ? 1 : 0) | (s_stuck != 0 ? 2 : 0));
    grid.sync();
    TRACE(2 + 2 * r);
    const int flags = *(volatile int*)(ctl + (r & 1));
    if (flags == 1) continue;
    for (long long x = first; x < n_new; x += stride) claim[x] = -1;
    if (first == 0) {
      ctl[4] = r + 1;
      ctl[5] = flags >> 1;
    }
    grid.sync();
    TRACE(3 + 2 * r);
    return;
  }
}

#undef TRACE

template <int G, bool Align>
int launch_group(const void* keys, const void* vals, const void* q,
                 long long n, unsigned D, unsigned cap, int max_probes,
                 void* found, void* stream) {
  const long long blocks = (n * G + kThreads - 1) / kThreads;
  probe_group<G, Align><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint4*)q, n, D, cap,
      max_probes, (uint32_t*)found);
  return (int)cudaGetLastError();
}

}  // namespace

#define BKW_GROUP_ENTRY(name, G, Align)                                    \
  extern "C" int name(const void* keys, const void* vals, const void* q,   \
                      long long n, unsigned int D, unsigned int cap,       \
                      int max_probes, void* found, void* stream) {         \
    return launch_group<G, Align>(keys, vals, q, n, D, cap, max_probes,    \
                                  found, stream);                          \
  }
BKW_GROUP_ENTRY(bkw_probe_g4_aligned, 4, true)
BKW_GROUP_ENTRY(bkw_probe_g8_aligned, 8, true)
BKW_GROUP_ENTRY(bkw_probe_g8_unaligned, 8, false)

extern "C" int bkw_probe_one_wide(const void* keys, const void* vals,
                                  const void* q, long long n, unsigned int D,
                                  unsigned int cap, int max_probes,
                                  void* found, void* stream) {
  probe_one_wide<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint4*)q, n, D, cap,
      max_probes, (uint32_t*)found);
  return (int)cudaGetLastError();
}

// migrate_traced as the port launches migrate_kernel: a cooperative grid
// of the co-resident block count or fewer; ctl holds 8 + 2 * 56 ints.
extern "C" int bkw_migrate_traced(const void* ok, const void* ov,
                                  long long n_old, unsigned int old_cap,
                                  void* nk, void* nv, unsigned int new_cap,
                                  long long n_new, int max_probes,
                                  void* gslot, void* lists, void* claim,
                                  void* ctl, void* stream) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)migrate_traced, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long co = (long long)per_sm * sms;
  const long long wanted = (n_old + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(wanted < co ? wanted : co);
  const uint4* ok_p = (const uint4*)ok;
  const uint32_t* ov_p = (const uint32_t*)ov;
  uint4* nk_p = (uint4*)nk;
  uint32_t* nv_p = (uint32_t*)nv;
  int* gslot_p = (int*)gslot;
  int* lists_p = (int*)lists;
  int* claim_p = (int*)claim;
  int* ctl_p = (int*)ctl;
  void* args[] = {&ok_p,    &ov_p,       &n_old,   &old_cap, &nk_p,
                  &nv_p,    &new_cap,    &n_new,   &max_probes,
                  &gslot_p, &lists_p,    &claim_p, &ctl_p};
  return (int)cudaLaunchCooperativeKernel((const void*)migrate_traced,
                                          dim3(blocks), dim3(kThreads), args,
                                          0, (cudaStream_t)stream);
}
