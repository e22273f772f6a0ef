// Dedup hash table for Hopper (sm_90a): batched probe, insert rounds and
// the migration of the open-addressed fingerprint table into a larger one.
//
// Replaces an XLA program, not a Pallas kernel: the shard-local probe and
// insert of backuwup_tpu/ops/dedup_index.py _build_probe_fn (local_probe,
// attempt and the retry while_loop) and the rehash of _build_migrate_fn.
// The table is (D, capacity) slots of a 16-byte key (four u32 words of a
// BLAKE3 digest, all-zero = empty) and a u32 value.  A query's shard is
// q[0] % D, its first slot q[1] % capacity, and it probes linearly for at
// most max_probes slots; found = value + 1 (u32, wrapping) or 0.  The
// capacity need not be a power of two, so a walk takes its start slot with
// one 32-bit % and then steps by increment and wrap.
//
// Round semantics are the JAX program's, so tables match bit for bit:
//   1. probe every active query against the table as it stood at the
//      start of the round (read only), and claim the first empty slot
//      (new keys) with atomicMax of the query index into a per-slot claim
//      vector: the highest query index wins, as XLA's scatter lets the
//      last update win;
//   2. (after a grid-wide barrier) each winner writes its whole key row
//      and its value;
//   3. every new key that finds another key in its slot lost a race and
//      is retried in the next round; the claim vector is all -1 again
//      between calls.
// Insert runs one round plus up to 10 retry rounds while any lane lost a
// race, with no host sync.  An atomicCAS insert that probed on after
// losing would let a repeat of a key in the same batch see the first
// occurrence as resident; the rounds keep "every occurrence reports the
// pre-batch state".  The migration runs the same rounds over the old
// table's slots (a nonzero key is pending; keys of one shard are distinct,
// so its walk looks for the first empty slot only) until nothing is
// pending or a walk is exhausted -- the JAX loop, which has no round cap.
//
// Bound on an H100: bytes, counted in 32-byte sectors.  Per probe step one
// sector of keys per query still probing, one of values at a hit, plus the
// query row and the outputs; at load factor a linear probing needs
// ~(1 + 1/(1-a))/2 steps for a hit and ~(1 + 1/(1-a)^2)/2 for a miss.
// The accesses are random, so what limits is the card's rate of scattered
// sector accesses, well below its streaming rate, and each walk is a
// chain of dependent loads of ~1 us.
//
// The insert and the migration are each ONE cooperative launch
// (cudaLaunchCooperativeKernel, grid = the co-resident block count or
// fewer, found per device with the kernel's own occupancy, slots or lanes
// walked by grid-stride loops): grid barriers replace the launch
// boundaries inside and between rounds, and every block leaves the round
// loop on the same counter or flag read after a barrier, which the kernel
// zeroes itself.  Their walks load kWide slots per round trip, through L2
// (another SM may have written them since the last barrier, and L1 is not
// coherent).  The migration's rounds after the first take only the keys
// still pending, from lists each block keeps of its own (see
// migrate_kernel); before this design a growth was a round of three
// launches, a memset and a host read per round.
//
// The probe is read only and its queries independent: a group of kGroup
// = 4 threads per query, thread g loading walk position w * 4 + g of the
// query's window w, the 4 consecutive slots from its start slot on (it
// wraps at the end of the shard); a ballot over the group and __ffs pick
// the first terminal slot in probe order (the key or an empty slot), and
// the next window is loaded only when this one holds none.  At load 0.5 a
// walk takes 1.5 steps on a hit and 2.5 on a miss, so a window of 4 ends
// ~86% of the misses and more of the hits; a window of 8 ends ~96% but
// reads twice the sectors, and the probe is bound by sector accesses, not
// by round trips: 4 is the faster on an H100, and windows aligned in
// memory are no faster than windows from the start slot
// (scripts/torch_k5_variants.py times them).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // probe threads per query
static_assert(kThreads % kGroup == 0, "blocks hold whole probe groups");

// insert lane state
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

// x reduced into [0, cap) for x < cap + step, step <= 8: one subtraction
// unless the shard is smaller than the step
__device__ __forceinline__ uint32_t wrap(uint32_t x, uint32_t cap,
                                         uint32_t step) {
  if (x < cap) return x;
  return cap >= step ? x - cap : x % cap;
}

// The first slot (local index) of shard `base` from key.y % cap that holds
// `key` (kMatch) or is empty, -1 when max_probes slots hold neither; *hit
// says which.  kWide slots per round trip (their loads issued together,
// then checked in order; slots past max_probes are read, never used),
// through L2 only.  A round lasts as long as its longest walk, a chain of
// dependent loads, so the chain is cut kWide-fold.
constexpr int kWide = 4;

template <bool kMatch>
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
      k[j] = __ldcg(keys + base + idx);
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

// One group of kGroup lanes per query (n * kGroup threads; blocks hold
// whole groups, so a group leaves or stays as one and its ballot mask is
// exact).  Lane g of window w holds walk position p = w * kGroup + g.
// The first terminal slot in probe order ends the walk; only its lane
// reads a value.
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint4* __restrict__ keys, const uint32_t* __restrict__ vals,
             const uint4* __restrict__ q, long long n, uint32_t D,
             uint32_t cap, int max_probes, uint32_t* __restrict__ found) {
  const long long i =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int first_lane = lane & ~(kGroup - 1);
  const int g = lane - first_lane;
  const unsigned mask = ((1u << kGroup) - 1u) << first_lane;
  const uint4 key = __ldg(q + i);
  if (zero4(key)) {  // all-zero rows are padding: they probe nothing
    if (g == 0) found[i] = 0;
    return;
  }
  const long long base = (long long)(key.x % D) * cap;
  uint32_t idx = wrap(key.y % cap + (uint32_t)g, cap, kGroup);
  int writer = 0;  // the lane that writes found[i]
  uint32_t f = 0;
  for (int p0 = 0; p0 < max_probes; p0 += kGroup) {
    const uint4 k = __ldg(keys + base + idx);
    const bool live = p0 + g < max_probes;
    const bool match = live && eq4(k, key);
    const unsigned term =
        __ballot_sync(mask, match || (live && zero4(k))) >> first_lane;
    if (term != 0u) {
      writer = __ffs(term) - 1;
      if (g == writer && match) f = __ldg(vals + base + idx) + 1u;
      break;
    }
    idx = wrap(idx + kGroup, cap, kGroup);
  }
  if (g == writer) found[i] = f;
}

// The whole insert, every round, in one cooperative launch: a thread keeps
// the same lanes in every round, so state and gslot are its own, and grid
// barriers separate the three steps of a round.  Every thread reaches
// every barrier; the loop ends for the whole grid at once, when the
// round's race counter (read after the barrier) is 0 -- the JAX loop's
// condition any(race) & (r < 10).
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
              walk_wide<true>(keys, base, cap, key, max_probes, &hit);
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

// The whole migration, every round, in one cooperative launch.  A round
// is two barriers: the walk and claim, then the resolution, in which the
// highest claimant of a slot writes it and every other claimant knows it
// lost from the claim vector alone (the reference reads the stored key
// back: the same unless two claimants carry one key, which a loser then
// compares).  Round 0 takes every old slot (block b the slots b * kThreads
// + k * stride + thread), finds the resident keys itself and claims their
// start slots without reading the new table, which is empty at the start.
// Each block keeps the keys it lost in a list of its own (a segment as
// long as its round-0 share, appended through shared memory), and each
// later round takes only those lists, so no global counter is contended
// and a round costs what its pending keys cost.  A claimed slot is
// occupied from then on and no walk claims it again, so the claim vector
// goes back to -1 in one sweep at the end.
// gslot[j]: the slot old slot j claimed last, -1 when its walk was
// exhausted, -2 when it holds no key.  lists: two lists of n_old old
// slots, round r reading list r % 2 and appending to the other.
// ctl: [r % 2] bit 0: keys still pending after round r, bit 1: a walk was
// exhausted in it (zeroed as round r starts; round r - 2 read it last),
// [4] rounds run, [5] whether a walk was exhausted.
__global__ void __launch_bounds__(kThreads)
migrate_kernel(const uint4* __restrict__ ok, const uint32_t* __restrict__ ov,
               long long n_old, uint32_t old_cap, uint4* nk, uint32_t* nv,
               uint32_t new_cap, long long n_new, int max_probes,
               int* __restrict__ gslot, int* lists, int* claim, int* ctl) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_next, s_stuck;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  // this block's list segment: as long as its share of round 0's slots
  const long long full = n_old / stride, rest = n_old - full * stride;
  const long long seg = blockIdx.x * full * kThreads +
                        min(rest, (long long)blockIdx.x * kThreads);
  int n_cur = 0;  // the length of this block's list for the round
  for (int r = 0;; ++r) {
    const int* list = lists + (r & 1) * n_old + seg;
    int* next = lists + ((r + 1) & 1) * n_old + seg;
    if (first == 0) ctl[r & 1] = 0;
    if (threadIdx.x == 0) s_next = s_stuck = 0;
    // 1. walk the new table as it stood at the start of the round to the
    //    first empty slot and claim it, the highest old slot winning
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
        const long long s = walk_wide<false>(nk, base, new_cap,
                                             __ldg(ok + j), max_probes, &hit);
        int g = -1;
        if (s >= 0) {
          g = (int)(base + s);
          atomicMax(&claim[g], (int)j);
        }
        gslot[j] = g;
      }
    }
    grid.sync();
    // 2. the highest claimant writes its key row and its value; the others
    //    go on the block's next list (whole warps iterate together, so a
    //    warp appends with one shared atomic)
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
    const int flags = *(volatile int*)(ctl + (r & 1));
    if (flags == 1) continue;
    // done: nothing pending, or a walk exhausted (bit 1)
    for (long long x = first; x < n_new; x += stride) claim[x] = -1;
    if (first == 0) {
      ctl[4] = r + 1;
      ctl[5] = flags >> 1;
    }
    return;
  }
}

inline bool bad_sizes(long long n, unsigned D, unsigned cap, int max_probes) {
  return n <= 0 || n > 0x7fffffffLL || D == 0 || cap == 0 ||
         (long long)D * cap > 0x7fffffffLL || max_probes <= 0;
}

// Co-resident blocks of kThreads for `kernel` on the current device, from
// its own occupancy, looked up once per kernel and device.
constexpr int kMaxDevices = 64;

cudaError_t coresident(const void* kernel, int* per_sm_of, long long* out) {
  static int sms_of[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0 || sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
    sms_of[dev] = sms;
    per_sm_of[dev] = per_sm;
  }
  *out = (long long)per_sm_of[dev] * sms_of[dev];
  return cudaSuccess;
}

// blocks of a cooperative grid-stride launch over n items
unsigned grid_for(long long n, long long coresident) {
  const long long wanted = (n + kThreads - 1) / kThreads;
  return (unsigned)(wanted < coresident ? wanted : coresident);
}

}  // namespace

extern "C" int bkw_dedup_probe(const void* keys, const void* vals,
                               const void* q, long long n, unsigned int D,
                               unsigned int cap, int max_probes, void* found,
                               void* stream) {
  if (bad_sizes(n, D, cap, max_probes) || (uintptr_t)q % 16 ||
      (uintptr_t)keys % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n * kGroup + kThreads - 1) / kThreads;
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)keys, (const uint32_t*)vals, (const uint4*)q, n, D, cap,
      max_probes, (uint32_t*)found);
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
  static int per_sm_of[kMaxDevices];
  long long co;
  cudaError_t err =
      coresident((const void*)insert_rounds_kernel, per_sm_of, &co);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_for(n, co);
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

extern "C" int bkw_dedup_migrate(const void* ok, const void* ov,
                                 long long n_old, unsigned int old_cap,
                                 void* nk, void* nv, unsigned int new_cap,
                                 long long n_new, int max_probes, void* gslot,
                                 void* lists, void* claim, void* ctl,
                                 void* stream) {
  if (bad_sizes(n_old, 1, old_cap, max_probes) || new_cap == 0 ||
      n_new <= 0 || n_new > 0x7fffffffLL || n_old % old_cap != 0 ||
      n_new % new_cap != 0 || n_new / new_cap != n_old / old_cap ||
      (uintptr_t)ok % 16 || (uintptr_t)nk % 16)
    return (int)cudaErrorInvalidValue;
  static int per_sm_of[kMaxDevices];
  long long co;
  cudaError_t err = coresident((const void*)migrate_kernel, per_sm_of, &co);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_for(n_old, co);
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
  return (int)cudaLaunchCooperativeKernel((const void*)migrate_kernel,
                                          dim3(blocks), dim3(kThreads), args,
                                          0, (cudaStream_t)stream);
}
