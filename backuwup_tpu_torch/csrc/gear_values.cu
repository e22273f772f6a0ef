// Gear table lookup for Hopper (sm_90a): g[i] = GEAR[b[i]] for a byte
// vector of any length at any byte offset.
//
// Replaces the Pallas kernel backuwup_tpu/ops/pallas_kernels.py
// _gear_kernel (called by gear_values_pallas), which expands each byte
// into a one-hot row and contracts it against the table's four 8-bit
// limbs on the TPU's matrix unit.  That trick exists because the TPU has
// no cheap per-lane table lookup; an SM has one (shared memory), so it is
// not carried over.
//
// Bound on an H100: bytes.  Each input byte is read once (1 B) and its
// gear value written once (4 B): 5 B per byte, 640 MiB for a 128 MiB
// vector, ~0.20 ms at 3.35 TB/s.  The lookups are one shared-memory load
// per byte (~3.5-way bank conflicts among a warp's random bytes), far
// below the time of the bytes.
//
// Design: every block builds the 256-entry table in shared memory (GEAR[b]
// = fmix32(b + GEAR_SEED32), ops/gear.py).  A thread takes kGroups groups
// of 4 input bytes, 256 groups apart, and writes each group's 4 values as
// one 16-byte streaming store (__stcs), so a warp's load reads 128
// contiguous bytes and its store writes 512.  Inputs at any byte offset
// take this one path: group k's bytes are the aligned words k and k + 1
// around it, realigned by one funnel shift (the second load only when the
// input is unaligned); words whose start lies past the input read 0.
// The output is a fresh allocation (16-byte aligned); a last group of 1-3
// values is stored one by one.  The kernel it replaced wrote four 16-byte
// stores at a 64-byte stride per thread; that pattern alone cost ~0.17 ms
// of 128 MiB on the card, and 4 or 16 groups per thread or 32 per-lane
// tables change nothing measurable (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one table entry per thread
constexpr int kGroups = 8;     // 4-byte groups per thread
constexpr uint32_t kGearSeed = 0x6261636Bu;  // "back", ops/gear.py

__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t h = b + kGearSeed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
gear_values_kernel(const uint8_t* __restrict__ b, uint32_t* __restrict__ g,
                   long long n) {
  __shared__ uint32_t tab[256];
  tab[threadIdx.x] = gear(threadIdx.x);
  __syncthreads();
  const uint8_t* end = b + n;
  const uintptr_t start = (uintptr_t)b;
  const unsigned shift = 8u * (unsigned)(start & 3u);
  // aligned word k holds input bytes 4k - start % 4 .. 4k - start % 4 + 3;
  // the word holding input byte 4k lies in mapped memory, as does any word
  // that starts before the end
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
  const long long whole = n >> 2;  // groups of 4 values
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const long long k = k0 + (long long)u * kThreads;
    const uint32_t x = w[u];
    const uint4 v = make_uint4(tab[x & 0xFFu], tab[(x >> 8) & 0xFFu],
                               tab[(x >> 16) & 0xFFu], tab[x >> 24]);
    if (k < whole) {
      __stcs(reinterpret_cast<uint4*>(g) + k, v);  // streamed: not read here
    } else if (k == whole) {  // the last 1-3 values, if any
      const int rest = (int)(n & 3);
      if (rest > 0) g[4 * k] = v.x;
      if (rest > 1) g[4 * k + 1] = v.y;
      if (rest > 2) g[4 * k + 2] = v.z;
    }
  }
}

}  // namespace

extern "C" int bkw_gear_values(const void* b, void* g, long long n,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)g & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  const long long per_block = (long long)kThreads * kGroups * 4;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gear_values_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)b, (uint32_t*)g, n);
  return (int)cudaGetLastError();
}
