// Gear table lookup for Hopper (sm_90a): g[i] = GEAR[b[i]] for a byte
// vector of any length.
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
// vector, ~0.20 ms at 3.35 TB/s.  The lookups are ~1 shared-memory load
// per byte, far below the instruction rate.  Design: every block builds
// the 256-entry table in shared memory (GEAR[b] = fmix32(b + GEAR_SEED32),
// ops/gear.py); a grid-stride loop gives each thread 16 bytes at a time
// (one 16-byte load, four 16-byte stores) when the input is 16-byte
// aligned, and the tail (or an unaligned input) goes byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ uint4 lookup4(const uint32_t* tab, uint32_t w) {
  return make_uint4(tab[w & 0xFFu], tab[(w >> 8) & 0xFFu],
                    tab[(w >> 16) & 0xFFu], tab[w >> 24]);
}

__global__ void __launch_bounds__(kThreads)
gear_values_kernel(const uint8_t* __restrict__ b, uint32_t* __restrict__ g,
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

}  // namespace

extern "C" int bkw_gear_values(const void* b, void* g, long long n,
                               void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte loads need a 16-byte aligned input; the output is a fresh
  // allocation (256-byte aligned)
  const bool aligned = ((uintptr_t)b & 15u) == 0 && ((uintptr_t)g & 15u) == 0;
  const long long n_vec = aligned ? n / 16 : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  gear_values_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)b, (uint32_t*)g, n, n_vec);
  return (int)cudaGetLastError();
}
