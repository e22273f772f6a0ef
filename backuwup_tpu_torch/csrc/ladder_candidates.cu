// Flat-ladder CDC candidates for Hopper (sm_90a): from precomputed u32
// gear values, the 32-tap windowed hash and both candidate masks, one u8
// flag per position and mask.
//
// Replaces the Pallas kernel backuwup_tpu/ops/pallas_kernels.py
// _make_ladder_cand_kernel (called by ladder_candidates_pallas).  Same
// contract: h[p] = sum_{k<32} g[p-k] << k (mod 2^32) with g[<0] = 0,
// cl[p] = ((h & mask_l) == 0) && p < n_valid, cs[p] = cl[p] &&
// ((h & mask_s) == 0).  The Pallas kernel runs five doubling passes over a
// (512, 128) VMEM tile because Mosaic has no flat shift; none of that is
// carried over.
//
// Bound on an H100: bytes.  Per position it reads 4 B and writes 2 B:
// 768 MiB for 128 Mi positions, ~0.24 ms at 3.35 TB/s.  The fewest
// instructions per position are 5 (one shift-add of the rolling form, two
// and-tests -- cs tests mask_l | mask_s at once -- and two flag packs),
// ~0.04 ms at the int32 rate.
//
// Design: taps older than 32 shift out mod 2^32, so the window is the
// recurrence h[p] = (h[p-1] << 1) + g[p], one shift-add per position.  A
// thread owns a run of kRun = 16 consecutive positions and a warp a span
// of 32 runs.  Each thread rolls its run from 0 to its local end L; the
// exact hash at the end of run t is H(t) = L(t) + (L(t-1) << 16) (run
// t-2's terms shift out), one warp shuffle; one more hands each thread
// H(t-1), from which it rolls its 16 exact hashes.  Lane 0 takes the
// exact hash before the span (the carry) instead, from a warm-up that sums
// g[p-k] << k over the 32 values before the span across the warp (one
// coalesced 128-byte load, which the warp before has mostly brought into
// L2).  Loads are coalesced 4-byte loads into a warp-private shared tile
// padded so a quarter-warp's 16-byte run reads hit distinct banks; each
// thread packs its flags four to a word and stores 16 B per mask, so a
// warp writes 512 contiguous bytes of each of cl and cs.  Positions at or
// past n_valid still hash; only their flags are zeroed.  Runs of 8 or 32,
// streaming stores and warps that walk 4 or 16 spans passing the carry on
// timed within noise of this or slower on the card (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;                // positions one thread owns
constexpr int kSpan = 32 * kRun;        // positions one warp owns
constexpr long long kBlock = (long long)kWarps * kSpan;  // 4,096
constexpr unsigned kAll = 0xFFFFFFFFu;

// word offset of run r in a warp's tile: 4 spare words after every second
// run, so lanes t..t+7 (t % 8 == 0) start their 16-byte reads on 8
// distinct 4-bank groups (16t + 4(t >> 1) mod 32 = 0, 16, 4, 20, ...)
__device__ __forceinline__ int slot(int r) { return kRun * r + 4 * (r >> 1); }
constexpr int kTile = kRun * 32 + 4 * 16;

__global__ void __launch_bounds__(kThreads)
ladder_candidates_kernel(const uint32_t* __restrict__ g,
                         uint4* __restrict__ cl, uint4* __restrict__ cs,
                         long long n_valid, uint32_t mask_l,
                         uint32_t mask_ls) {
  __shared__ __align__(16) uint32_t tiles[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  uint32_t* tile = tiles[threadIdx.x >> 5];
  const long long p0 = (long long)blockIdx.x * kBlock
                       + (long long)(threadIdx.x >> 5) * kSpan;
  // stage the span: word i (coalesced) goes to run i / 16; lanes write
  // 32 consecutive words of runs 2k, 2k + 1, one bank each
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = lane + 32 * k;
    tile[slot(i / kRun) + i % kRun] = __ldg(g + p0 + i);
  }
  // warm-up: the exact hash at p0 - 1 is sum_j g[p0 - 32 + j] << (31 - j)
  const long long e = p0 - 32 + lane;
  uint32_t carry = e >= 0 ? __ldg(g + e) << (31 - lane) : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) carry += __shfl_xor_sync(kAll, carry, o);
  __syncwarp();
  uint32_t x[kRun];
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(tile + slot(lane) + 4 * j);
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }

  uint32_t local = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) local = (local << 1) + x[i];
  // H(t) = L(t) + (H(t-1) << 16), and H(t-1) << 16 == L(t-1) << 16
  uint32_t prev = __shfl_up_sync(kAll, local, 1);
  if (lane == 0) prev = carry;
  const uint32_t end = local + (prev << 16);
  uint32_t h = __shfl_up_sync(kAll, end, 1);
  if (lane == 0) h = carry;

  uint32_t wl[kRun / 4], ws[kRun / 4];
#pragma unroll
  for (int j = 0; j < kRun / 4; ++j) wl[j] = ws[j] = 0u;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    h = (h << 1) + x[i];
    const uint32_t byte = 1u << (8 * (i & 3));
    if ((h & mask_l) == 0u) wl[i >> 2] |= byte;
    if ((h & mask_ls) == 0u) ws[i >> 2] |= byte;
  }
  const long long pos = p0 + (long long)kRun * lane;
  const long long left = n_valid - pos;
  if (left < kRun) {
#pragma unroll
    for (int j = 0; j < kRun / 4; ++j) {
      const long long nb = left - 4 * j;
      const uint32_t m = nb <= 0 ? 0u
                         : nb >= 4 ? kAll
                                   : (1u << (8 * (int)nb)) - 1u;
      wl[j] &= m;
      ws[j] &= m;
    }
  }
  cl[pos / 16] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  cs[pos / 16] = make_uint4(ws[0], ws[1], ws[2], ws[3]);
}

}  // namespace

extern "C" int bkw_ladder_candidates(const void* g, void* cl, void* cs,
                                     long long n, long long n_valid,
                                     unsigned int mask_s, unsigned int mask_l,
                                     void* stream) {
  if (n <= 0 || (n % kBlock) != 0) return (int)cudaErrorInvalidValue;
  // 16-byte flag stores: the wrapper's outputs are fresh allocations
  if ((((uintptr_t)cl | (uintptr_t)cs) & 15u) != 0 || ((uintptr_t)g & 3u))
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = n / kBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ladder_candidates_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)g, (uint4*)cl, (uint4*)cs, n_valid, (uint32_t)mask_l,
      (uint32_t)(mask_l | mask_s));
  return (int)cudaGetLastError();
}
