// CDC candidate scan for Hopper (sm_90a): gear hash, 32-tap windowed sum,
// both candidate masks and the 32:1 bit pack, in one pass over the bytes.
//
// Replaces the Pallas kernels backuwup_tpu/ops/scan_fused.py
// _make_scan_kernel (driver _fused_candidate_words_v1) and
// _make_scan_kernel_u32 (driver _fused_candidate_words_u32).  Same output
// contract: per row, wl/ws are (P/32) u32 words, position-major, bit t of
// word w = candidate at position 32*w + t (little-endian, as _pack_bits).
//
// Input: ext (B, 31+P) u8, each row 31 halo bytes then the stream, zero
// padded; nv (B,) i32 valid lengths.  h[p] = sum_{k<32} g[31+p-k] << k with
// g = fmix32(byte + GEAR_SEED32).  The halo always supplies the 31 bytes
// before position 0 (zeros at a stream start, which still enter the sum,
// exactly as backuwup_tpu/ops/cdc_tpu.py _hash_ext_fast), so no tile needs
// a special case.
//
// Bound on an H100: per byte it reads 1 B and writes 1/4 B, so a 128 MiB
// row is ~42 us at 3.35 TB/s; the arithmetic (~21 int32 instructions per
// position with a doubling ladder: fmix32 9, five fused shift-adds, masks,
// tests and ballots ~7) is ~0.17 ms at ~16.7 T int32 instructions/s, so the
// scan is bound by operations.  Design: one thread per position; a block stages
// its 256 positions plus the 31 preceding bytes into shared memory and
// computes each gear value once, then each thread sums its 32 taps from
// shared memory (direct taps: ~3x the ladder's operations, kept for
// simplicity; a ladder or a per-thread rolling run is later work).  Each
// warp owns 32 consecutive positions, so __ballot_sync gives the packed
// word directly and lane 0 stores it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 31;
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
scan_candidates_kernel(const uint8_t* __restrict__ ext,
                       const int32_t* __restrict__ nv,
                       uint32_t* __restrict__ wl, uint32_t* __restrict__ ws,
                       long long row_stride, long long P,
                       uint32_t mask_s, uint32_t mask_l) {
  __shared__ uint32_t g[kThreads + kHalo];
  const long long b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const uint8_t* row = ext + b * row_stride;
  // smem slot i holds the gear value of ext byte p0 + i; the row is
  // 31 + P bytes long and byte loads need no alignment (the row stride is
  // odd), a wider aligned load with shifts is later work
  for (int i = threadIdx.x; i < kThreads + kHalo; i += kThreads) {
    const long long e = p0 + i;
    g[i] = gear(e < kHalo + P ? (uint32_t)row[e] : 0u);
  }
  __syncthreads();
  const int t = threadIdx.x;
  const long long p = p0 + t;
  // P % 32 == 0, so a warp is wholly inside the row or wholly past it
  if (p0 + (t & ~31) >= P) return;
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) h += g[kHalo + t - k] << k;
  const bool cl = ((h & mask_l) == 0u) && (p < (long long)nv[b]);
  const bool cs = cl && ((h & mask_s) == 0u);
  const uint32_t wlv = __ballot_sync(0xffffffffu, cl);
  const uint32_t wsv = __ballot_sync(0xffffffffu, cs);
  if ((t & 31) == 0) {
    const long long w = b * (P >> 5) + (p >> 5);
    wl[w] = wlv;
    ws[w] = wsv;
  }
}

}  // namespace

extern "C" int bkw_scan_candidates(const void* ext, const void* nv, void* wl,
                                   void* ws, int B, long long P,
                                   unsigned int mask_s, unsigned int mask_l,
                                   void* stream) {
  if (B <= 0 || P <= 0 || (P % 32) != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)B);
  scan_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ext, (const int32_t*)nv, (uint32_t*)wl, (uint32_t*)ws,
      (long long)kHalo + P, P, (uint32_t)mask_s, (uint32_t)mask_l);
  return (int)cudaGetLastError();
}
