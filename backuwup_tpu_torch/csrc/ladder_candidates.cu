// Flat-ladder CDC candidates for Hopper (sm_90a): from precomputed u32
// gear values, the 32-tap windowed hash and both candidate masks, one u8
// flag per position and mask.
//
// Replaces the Pallas kernel backuwup_tpu/ops/pallas_kernels.py
// _make_ladder_cand_kernel (called by ladder_candidates_pallas).  Same
// contract: h[p] = sum_{k<32} g[p-k] << k (mod 2^32) with g[<0] = 0,
// cl[p] = ((h & mask_l) == 0) && p < n_valid, cs[p] = cl[p] &&
// ((h & mask_s) == 0).  The Pallas kernel runs five doubling passes over a
// (512, 128) VMEM tile plus an 8-row halo block because Mosaic has no
// flat shift; an SM reads any shared-memory word, so the tile here is
// flat and its halo is exactly the 31 values before it.
//
// Bound on an H100: bytes.  Per position it reads 4 B and writes 2 B:
// 768 MiB for 128 Mi positions, ~0.24 ms at 3.35 TB/s; the operations
// (five shift-adds of a ladder, two masks, their tests, the valid check
// and two byte stores, ~12 int32 instructions) are ~0.10 ms at the
// int32 instruction rate.  Design: one thread per position; a block
// stages its 256 gear values plus the 31 before them in shared memory
// (coalesced 4-byte loads) and each thread folds its 32 taps
// Horner-style, h = (h << 1) + g, from the oldest tap to its own (32
// shift-adds, more than the ladder's five, kept for simplicity).  Flag
// stores are one byte per thread, 32 consecutive bytes per warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 31;

__global__ void __launch_bounds__(kThreads)
ladder_candidates_kernel(const uint32_t* __restrict__ g,
                         uint8_t* __restrict__ cl, uint8_t* __restrict__ cs,
                         long long n, long long n_valid, uint32_t mask_s,
                         uint32_t mask_l) {
  __shared__ uint32_t tile[kThreads + kHalo];
  const long long p0 = (long long)blockIdx.x * kThreads;
  // tile slot i holds g[p0 - 31 + i]; n is a multiple of the block size,
  // so only the first block reads before the vector (zeros)
  for (int i = threadIdx.x; i < kThreads + kHalo; i += kThreads) {
    const long long e = p0 - kHalo + i;
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

}  // namespace

extern "C" int bkw_ladder_candidates(const void* g, void* cl, void* cs,
                                     long long n, long long n_valid,
                                     unsigned int mask_s, unsigned int mask_l,
                                     void* stream) {
  if (n <= 0 || (n % kThreads) != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = n / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ladder_candidates_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)g, (uint8_t*)cl, (uint8_t*)cs, n, n_valid,
      (uint32_t)mask_s, (uint32_t)mask_l);
  return (int)cudaGetLastError();
}
