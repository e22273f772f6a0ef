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
//   2. (next launch: a grid-wide ordering point) each winner writes its
//      whole key row and its value;
//   3. (next launch) every new key re-reads its slot; a different key
//      there is a lost race, retried in the next round; the claim slot is
//      reset to -1, so the vector is all -1 between rounds and calls.
// Insert runs one round plus a fixed 10 retry rounds with no host sync (a
// round with no active query changes nothing).  An atomicCAS insert that
// probed on after losing would let a repeat of a key in the same batch
// see the first occurrence as resident; the rounds keep "every occurrence
// reports the pre-batch state".
//
// Bound on an H100: bytes, counted in 32-byte sectors.  Per probe step one
// sector of keys per query still probing, one of values at a hit, plus the
// query row and the outputs; at load factor a linear probing needs
// ~(1 + 1/(1-a))/2 steps for a hit and ~(1 + 1/(1-a)^2)/2 for a miss.
// The accesses are random, so every step is a separate sector and
// latency, not bandwidth, dominates at these batch sizes.  Design: one
// thread per query, 16-byte key loads, no shared memory; the three steps
// of a round are three launches.

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads)
insert_probe_kernel(const uint4* __restrict__ keys,
                    const uint32_t* __restrict__ vals,
                    const uint32_t* __restrict__ q, long long n, uint32_t D,
                    uint32_t cap, int max_probes, int first_round,
                    uint32_t* __restrict__ found, uint8_t* __restrict__ state,
                    long long* __restrict__ gslot, int* __restrict__ claim) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint8_t st = state[i];
  uint32_t f = 0;
  bool is_new = false, exhausted = false;
  if (st & kActive) {
    const uint4 key = row4(q, i);
    if (!zero4(key)) {
      const long long base = (long long)(key.x % D) * cap;
      bool hit;
      const long long s = walk(keys, base, cap, key, max_probes, true, &hit);
      if (s < 0) {
        exhausted = true;
      } else {
        if (hit) f = vals[base + s] + 1u;
        // a found value of 0xFFFFFFFF wraps to 0 and re-writes its own
        // slot, as the JAX program does
        if (f == 0u) {
          is_new = true;
          gslot[i] = base + s;
          atomicMax(&claim[base + s], (int)i);
        }
      }
    }
  }
  if (first_round) found[i] = f;
  state[i] = (st & (kActive | kExhausted)) | (exhausted ? kExhausted : 0) |
             (is_new ? kNew : 0);
}

__global__ void __launch_bounds__(kThreads)
insert_write_kernel(uint4* __restrict__ keys, uint32_t* __restrict__ vals,
                    const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ v, long long n,
                    const uint8_t* __restrict__ state,
                    const long long* __restrict__ gslot,
                    const int* __restrict__ claim) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !(state[i] & kNew)) return;
  const long long g = gslot[i];
  if (claim[g] != (int)i) return;
  keys[g] = row4(q, i);
  vals[g] = v[i];
}

__global__ void __launch_bounds__(kThreads)
insert_race_kernel(const uint4* __restrict__ keys,
                   const uint32_t* __restrict__ q, long long n,
                   uint8_t* __restrict__ state,
                   const long long* __restrict__ gslot,
                   int* __restrict__ claim, uint32_t* __restrict__ lost) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint8_t st = state[i];
  bool race = false;
  if (st & kNew) {
    const long long g = gslot[i];
    race = !eq4(keys[g], row4(q, i));
    claim[g] = -1;
  }
  const bool exh = (st & kExhausted) != 0;
  // the losers are the next round's active set
  state[i] = (race ? kActive : 0) | (exh ? kExhausted : 0);
  lost[i] = (race ? 1u : 0u) + (exh ? 2u : 0u);
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
                                void* gslot, void* claim, void* stream) {
  if (bad_sizes(n, D, cap, max_probes) || rounds <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(state, kActive, (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  for (int r = 0; r < rounds; ++r) {
    insert_probe_kernel<<<grid(n), kThreads, 0, s>>>(
        (const uint4*)keys, (const uint32_t*)vals, (const uint32_t*)q, n, D,
        cap, max_probes, r == 0, (uint32_t*)found, (uint8_t*)state,
        (long long*)gslot, (int*)claim);
    insert_write_kernel<<<grid(n), kThreads, 0, s>>>(
        (uint4*)keys, (uint32_t*)vals, (const uint32_t*)q,
        (const uint32_t*)v, n, (const uint8_t*)state,
        (const long long*)gslot, (const int*)claim);
    insert_race_kernel<<<grid(n), kThreads, 0, s>>>(
        (const uint4*)keys, (const uint32_t*)q, n, (uint8_t*)state,
        (const long long*)gslot, (int*)claim, (uint32_t*)lost);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
