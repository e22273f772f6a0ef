// BLAKE3 leaf scan for Hopper (sm_90a): the 16-block compression chain of
// one 1 KiB BLAKE3 chunk per lane.
//
// Replaces the Pallas kernel backuwup_tpu/ops/blake3_tpu.py
// _leaf_scan_kernel (driver _leaf_scan_pallas), with the same contract:
// words (lanes, 256) u32 (16 blocks x 16 message words, little-endian),
// nb (lanes,) i32 block count, lbl (lanes,) u32 last-block length,
// counter (lanes,) i32 chunk counter -> cv (lanes, 8) u32 leaf chaining
// value and cvp (lanes, 8) u32, the input CV of the last block (used for
// the single-chunk ROOT recompute).  Masking mirrors _leaf_scan_kernel:
// block blk is active iff blk < nb; CHUNK_START on block 0, CHUNK_END and
// block length lbl on block nb-1 (64 before it); counter_hi = 0.
//
// Bound on an H100: one compression is 7 rounds x 8 G x 12 int32
// instructions (2 three-input adds, 2 adds, 4 xors, 4 funnel shifts) plus
// 8 output xors (680), up to 16 per leaf (~10.9 k), so a 131,072-leaf
// (128 MiB) pool is ~1.43 G instructions, ~0.085 ms at ~16.7 T int32
// instructions/s; reading its 128 MiB of words is ~40 us, so the scan is
// bound by operations.  Design: one thread per lane keeps the 8-word CV, the
// 16-word state and the 16 message words in registers; rounds and the
// message schedule are unrolled so every index is a compile-time constant
// (no local memory), and rotations are __funnelshift_r.  Known slowness:
// each thread reads its own 1 KiB, so a warp's loads stride by 1 KiB and
// do not coalesce; staging through shared memory, or fusing the gather
// from the flat byte pool, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;

__constant__ uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                0x1F83D9ABu, 0x5BE0CD19u};

// message word order of each round: MSG_PERMUTATION applied r times
// (ops/blake3_cpu.py), as in the BLAKE3 reference implementation
__device__ __forceinline__ constexpr int sched(int r, int i) {
  constexpr int S[7][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8},
      {3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1},
      {10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6},
      {12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4},
      {9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7},
      {11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13},
  };
  return S[r][i];
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(uint32_t* v, int a, int b, int c, int d,
                                  uint32_t mx, uint32_t my) {
  v[a] = v[a] + v[b] + mx;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + my;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

// cv <- first 8 words of compress(cv, m, counter, 0, blen, flags)
__device__ __forceinline__ void compress(uint32_t* cv, const uint32_t* m,
                                         uint32_t counter, uint32_t blen,
                                         uint32_t flags) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    kIV[0], kIV[1], kIV[2], kIV[3], counter, 0u, blen, flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(v, 0, 4, 8, 12, m[sched(r, 0)], m[sched(r, 1)]);
    g(v, 1, 5, 9, 13, m[sched(r, 2)], m[sched(r, 3)]);
    g(v, 2, 6, 10, 14, m[sched(r, 4)], m[sched(r, 5)]);
    g(v, 3, 7, 11, 15, m[sched(r, 6)], m[sched(r, 7)]);
    g(v, 0, 5, 10, 15, m[sched(r, 8)], m[sched(r, 9)]);
    g(v, 1, 6, 11, 12, m[sched(r, 10)], m[sched(r, 11)]);
    g(v, 2, 7, 8, 13, m[sched(r, 12)], m[sched(r, 13)]);
    g(v, 3, 4, 9, 14, m[sched(r, 14)], m[sched(r, 15)]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

__global__ void __launch_bounds__(kThreads)
blake3_leaf_kernel(const uint4* __restrict__ words,
                   const int32_t* __restrict__ nb,
                   const uint32_t* __restrict__ lbl,
                   const int32_t* __restrict__ counter,
                   uint32_t* __restrict__ cv_out,
                   uint32_t* __restrict__ cvp_out, long long lanes) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t cv[8], cvp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = cvp[i] = kIV[i];
  const int n = min(nb[lane], 16);
  const uint32_t last_len = lbl[lane];
  const uint32_t ctr = (uint32_t)counter[lane];
  const uint4* lw = words + lane * 64;  // 256 u32 = 64 uint4 per lane
  // blocks at or past nb leave cv and cvp unchanged, so the loop stops
  for (int blk = 0; blk < n; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = lw[blk * 4 + q];
      m[4 * q + 0] = x.x;
      m[4 * q + 1] = x.y;
      m[4 * q + 2] = x.z;
      m[4 * q + 3] = x.w;
    }
    const bool is_last = blk == n - 1;
    uint32_t flags = blk == 0 ? CHUNK_START : 0u;
    if (is_last) {
      flags |= CHUNK_END;
#pragma unroll
      for (int i = 0; i < 8; ++i) cvp[i] = cv[i];
    }
    compress(cv, m, ctr, is_last ? last_len : 64u, flags);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cv_out[lane * 8 + i] = cv[i];
    cvp_out[lane * 8 + i] = cvp[i];
  }
}

}  // namespace

extern "C" int bkw_blake3_leaf(const void* words, const void* nb,
                               const void* lbl, const void* counter,
                               void* cv, void* cvp, long long lanes,
                               void* stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  blake3_leaf_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int32_t*)nb, (const uint32_t*)lbl,
      (const int32_t*)counter, (uint32_t*)cv, (uint32_t*)cvp, lanes);
  return (int)cudaGetLastError();
}
