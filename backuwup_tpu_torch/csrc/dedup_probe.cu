// Dedup hash table for Hopper (sm_90a): batched probe, insert rounds and
// migration rounds of the open-addressed fingerprint table.
//
// Replaces an XLA program, not a Pallas kernel: the shard-local probe and
// insert of backuwup_tpu/ops/dedup_index.py _build_probe_fn (local_probe,
// attempt and the retry while_loop) and the rehash of _build_migrate_fn.
// The table is (D, capacity) slots of a 16-byte key (four u32 words of a
// BLAKE3 digest, all-zero = empty) and a u32 value.  A query's shard is
// q[0] % D, its first slot q[1] % capacity, and it probes linearly for at
// most max_probes slots; found = value + 1 (u32, wrapping) or 0.
//
// Round semantics are the JAX program's, so tables match bit for bit:
//   1. probe every active query against the table as it stood at the
//      start of the round (read only), and claim the first empty slot
//      (new keys) with atomicMax of the query index into a per-slot claim
//      vector: the highest query index wins, as XLA's scatter lets the
//      last update win;
//   2. (after a grid-wide barrier) each winner writes its whole key row
//      and its value;
//   3. (after another) every new key re-reads its slot; a different key
//      there is a lost race, retried in the next round; the claim slot is
//      reset to -1, so the vector is all -1 between rounds and calls.
// Insert runs one round plus up to 10 retry rounds while any lane lost a
// race, with no host sync.  An atomicCAS insert that probed on after
// losing would let a repeat of a key in the same batch see the first
// occurrence as resident; the rounds keep "every occurrence reports the
// pre-batch state".
//
// Bound on an H100: bytes, counted in 32-byte sectors.  Per probe step one
// sector of keys per query still probing, one of values at a hit, plus the
// query row and the outputs; at load factor a linear probing needs
// ~(1 + 1/(1-a))/2 steps for a hit and ~(1 + 1/(1-a)^2)/2 for a miss.
// The accesses are random, so every step is a separate sector and
// latency, not bandwidth, dominates at these batch sizes (an insert batch
// of ~65k lanes: ~3 us of bytes).  What limits the insert is launch and
// round overhead, so it is ONE cooperative launch (cudaLaunchCooperative-
// Kernel, grid = the co-resident block count or fewer, lanes walked by
// grid-stride loops): grid barriers replace the launch
// boundaries inside and between rounds, each warp adds its racing lanes to
// a per-round counter (zeroed by the kernel itself, so a call is one
// launch and nothing else), and every block leaves the round loop when
// the counter is 0 -- exactly the JAX loop's any(race) & (r < 10).  A round
// then lasts as long as its longest probe walk, dependent loads of ~1 us
// each, so the insert's walks load 4 slots per round trip.  The probe
// and each migration round (three launches) are one thread per lane,
// 16-byte key loads, no shared memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kActive = 1;     // probes this round
constexpr uint8_t kNew = 2;        // claimed an empty slot this round
constexpr uint8_t kExhausted = 4;  // walked max_probes slots, none terminal

__device__ __forceinline__ bool eq4(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

__device__ __forceinline__ bool zero4(uint4 a) {
  return (a.x | a.y | a.z | a.w) == 0u;
}

__device__ __forceinline__ uint4 row4(const uint32_t* q, long long i) {
  const uint32_t* r = q + 4 * i;
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// First slot (local index) of shard `base` holding `key` (when `match`)
// or empty, walking from key.y % cap; -1 when max_probes slots hold
// neither.  *hit says which.
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

// walk() for the insert rounds: the same first terminal slot, found with
// kWide slots per round trip (their loads issued together, then checked in
// order; slots past max_probes are read, never used) and the keys read
// through L2 only.  A round lasts as long as its longest walk, a chain of
// dependent loads, so the chain is cut kWide-fold.
constexpr int kWide = 4;

__device__ __forceinline__ long long walk_wide(const uint4* keys,
                                               long long base, uint32_t cap,
                                               uint4 key, int max_probes,
                                               bool* hit) {
  const unsigned long long start = key.y % cap;
  for (int p0 = 0; p0 < max_probes; p0 += kWide) {
    uint4 k[kWide];
#pragma unroll
    for (int j = 0; j < kWide; ++j)
      k[j] = __ldcg(keys + base + (long long)((start + (unsigned)(p0 + j)) %
                                               cap));
#pragma unroll
    for (int j = 0; j < kWide; ++j) {
      if (p0 + j >= max_probes) break;
      const long long idx = (long long)((start + (unsigned)(p0 + j)) % cap);
      if (eq4(k[j], key)) {
        *hit = true;
        return idx;
      }
      if (zero4(k[j])) {
        *hit = false;
        return idx;
      }
    }
  }
  *hit = false;
  return -1;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint4* __restrict__ keys, const uint32_t* __restrict__ vals,
             const uint32_t* __restrict__ q, long long n, uint32_t D,
             uint32_t cap, int max_probes, uint32_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 key = row4(q, i);
  uint32_t f = 0;
  if (!zero4(key)) {  // all-zero rows are padding: they probe nothing
    const long long base = (long long)(key.x % D) * cap;
    bool hit;
    const long long s = walk(keys, base, cap, key, max_probes, true, &hit);
    if (hit) f = vals[base + s] + 1u;
  }
  found[i] = f;
}

// The whole insert, every round, in one cooperative launch: the grid is
// co-resident, lanes are walked by grid-stride loops (a thread keeps the
// same lanes in every round, so state and gslot are its own), and grid
// barriers separate the three steps of a round.  Table and claim reads go
// through L2 (__ldcg): another SM may have written them since the last
// barrier, and L1 is not coherent.
// Every thread reaches every barrier; the loop ends for the whole grid at
// once, when the round's race counter (read after the barrier) is 0 --
// the JAX loop's condition any(race) & (r < 10).
__global__ void __launch_bounds__(kThreads)
insert_rounds_kernel(uint4* keys, uint32_t* vals,
                     const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ v, long long n, uint32_t D,
                     uint32_t cap, int max_probes, int rounds,
                     uint32_t* __restrict__ found, uint32_t* __restrict__ lost,
                     uint8_t* __restrict__ state,
                     long long* __restrict__ gslot, int* claim, int* races) {
  cg::grid_group grid = cg::this_grid();
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // the race counters start at 0; the first add comes two barriers later
  if (blockIdx.x == 0 && threadIdx.x < rounds) races[threadIdx.x] = 0;
  for (int r = 0; r < rounds; ++r) {
    // 1. probe against the table as it stood at the start of the round;
    //    a new key claims its empty slot, the highest query index winning
    for (long long i = first; i < n; i += stride) {
      const uint8_t st = r == 0 ? kActive : state[i];
      uint32_t f = 0;
      bool is_new = false, exhausted = false;
      if (st & kActive) {
        const uint4 key = row4(q, i);
        if (!zero4(key)) {
          const long long base = (long long)(key.x % D) * cap;
          bool hit;
          const long long s =
              walk_wide(keys, base, cap, key, max_probes, &hit);
          if (s < 0) {
            exhausted = true;
          } else {
            if (hit) f = __ldcg(vals + base + s) + 1u;
            // a found value of 0xFFFFFFFF wraps to 0 and re-writes its
            // own slot, as the JAX program does
            if (f == 0u) {
              is_new = true;
              gslot[i] = base + s;
              atomicMax(&claim[base + s], (int)i);
            }
          }
        }
      }
      if (r == 0) found[i] = f;
      state[i] = (st & (kActive | kExhausted)) |
                 (exhausted ? kExhausted : 0) | (is_new ? kNew : 0);
    }
    grid.sync();
    // 2. each winner writes its whole key row and its value
    for (long long i = first; i < n; i += stride) {
      if (!(state[i] & kNew)) continue;
      const long long g = gslot[i];
      if (__ldcg(claim + g) != (int)i) continue;
      keys[g] = row4(q, i);
      vals[g] = v[i];
    }
    grid.sync();
    // 3. a new key that finds another key in its slot lost a race and is
    //    the next round's active set; the claim slot goes back to -1
    int mine = 0;
    for (long long i = first; i < n; i += stride) {
      const uint8_t st = state[i];
      bool race = false;
      if (st & kNew) {
        const long long g = gslot[i];
        race = !eq4(__ldcg(keys + g), row4(q, i));
        claim[g] = -1;
      }
      const bool exh = (st & kExhausted) != 0;
      state[i] = (race ? kActive : 0) | (exh ? kExhausted : 0);
      lost[i] = (race ? 1u : 0u) + (exh ? 2u : 0u);
      mine += race ? 1 : 0;
    }
    const int warp_races = __reduce_add_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0 && warp_races != 0)
      atomicAdd(races + r, warp_races);
    grid.sync();
    if (*(volatile int*)(races + r) == 0) break;
  }
}

// migration: pending bit 0 = still to place, bit 1 = claimed a slot
__global__ void __launch_bounds__(kThreads)
migrate_probe_kernel(const uint4* __restrict__ ok, long long n_old,
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
    flags[1] = 1;  // exhausted
    return;
  }
  pending[j] = 3;
  gslot[j] = base + s;
  atomicMax(&claim[base + s], (int)j);
}

__global__ void __launch_bounds__(kThreads)
migrate_write_kernel(const uint4* __restrict__ ok,
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
migrate_race_kernel(const uint4* __restrict__ ok, long long n_old,
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
  if (st & 1) flags[0] = 1;  // something still pending
}

inline unsigned grid(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline bool bad_sizes(long long n, unsigned D, unsigned cap, int max_probes) {
  return n <= 0 || n > 0x7fffffffLL || D == 0 || cap == 0 ||
         (long long)D * cap > 0x7fffffffLL || max_probes <= 0 ||
         (n + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

extern "C" int bkw_dedup_probe(const void* keys, const void* vals,
                               const void* q, long long n, unsigned int D,
                               unsigned int cap, int max_probes, void* found,
                               void* stream) {
  if (bad_sizes(n, D, cap, max_probes)) return (int)cudaErrorInvalidValue;
  probe_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint32_t*)q, n, D,
      cap, max_probes, (uint32_t*)found);
  return (int)cudaGetLastError();
}

extern "C" int bkw_dedup_insert(void* keys, void* vals, const void* q,
                                const void* v, long long n, unsigned int D,
                                unsigned int cap, int max_probes, int rounds,
                                void* found, void* lost, void* state,
                                void* gslot, void* claim, void* races,
                                void* stream) {
  if (bad_sizes(n, D, cap, max_probes) || rounds <= 0 || rounds > kThreads)
    return (int)cudaErrorInvalidValue;
  // co-resident blocks per SM and SMs, per device, looked up once
  constexpr int kMaxDevices = 64;
  static int per_sm_of[kMaxDevices], sms_of[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_sm_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, insert_rounds_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0 || sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    sms_of[dev] = sms;
    per_sm_of[dev] = per_sm;
  }
  const long long coresident = (long long)per_sm_of[dev] * sms_of[dev];
  const long long wanted = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(wanted < coresident ? wanted : coresident);
  uint4* keys_p = (uint4*)keys;
  uint32_t* vals_p = (uint32_t*)vals;
  const uint32_t* q_p = (const uint32_t*)q;
  const uint32_t* v_p = (const uint32_t*)v;
  uint32_t* found_p = (uint32_t*)found;
  uint32_t* lost_p = (uint32_t*)lost;
  uint8_t* state_p = (uint8_t*)state;
  long long* gslot_p = (long long*)gslot;
  int* claim_p = (int*)claim;
  int* races_p = (int*)races;
  void* args[] = {&keys_p, &vals_p, &q_p,  &v_p,     &n,       &D,
                  &cap,    &max_probes,    &rounds,  &found_p, &lost_p,
                  &state_p, &gslot_p,      &claim_p, &races_p};
  return (int)cudaLaunchCooperativeKernel((const void*)insert_rounds_kernel,
                                          dim3(blocks), dim3(kThreads), args,
                                          0, (cudaStream_t)stream);
}

extern "C" int bkw_dedup_migrate_round(const void* ok, const void* ov,
                                       long long n_old, unsigned int old_cap,
                                       void* nk, void* nv,
                                       unsigned int new_cap, long long n_new,
                                       int max_probes, void* pending,
                                       void* gslot, void* claim, void* flags,
                                       void* stream) {
  if (bad_sizes(n_old, 1, old_cap, max_probes) || new_cap == 0 ||
      n_new <= 0 || n_new > 0x7fffffffLL || n_old % old_cap != 0 ||
      n_new / new_cap != n_old / old_cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  migrate_probe_kernel<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, n_old, old_cap, (const uint4*)nk, new_cap,
      max_probes, (uint8_t*)pending, (long long*)gslot, (int*)claim,
      (int*)flags);
  migrate_write_kernel<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, (const uint32_t*)ov, n_old, (uint4*)nk,
      (uint32_t*)nv, (const uint8_t*)pending, (const long long*)gslot,
      (const int*)claim);
  migrate_race_kernel<<<grid(n_old), kThreads, 0, s>>>(
      (const uint4*)ok, n_old, (const uint4*)nk, (uint8_t*)pending,
      (const long long*)gslot, (int*)claim, (int*)flags);
  return (int)cudaGetLastError();
}
