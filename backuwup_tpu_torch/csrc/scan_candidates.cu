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
// before position 0 (zeros at a stream start, which still hash to
// fmix32(GEAR_SEED32) != 0 and enter the sum, exactly as
// backuwup_tpu/ops/cdc_tpu.py _hash_ext_fast), so no run needs a special
// case.
//
// Bound on an H100: per position it reads 1 B and writes 2 bits, so a
// 128 MiB row moves 168 MB, ~50 us at 3.35 TB/s.  The fewest instructions
// any correct design needs per position are 6: the gear value as one
// lookup in a 256-entry shared table (a byte extract and one LDS; fmix32
// takes 9), one fused shift-add, two mask tests and one pack step.  An
// LDS issues at 32 lanes per clock per SM, half the int32 rate, so at
// that rate it costs 2 and the 6 still cover it: ~48 us at ~16.7 T int32
// instructions/s.  So the bound is the bytes', by a little.
//
// Design: the rolling form h[p] = (h[p-1] << 1) + g[31+p] mod 2^32 (the
// term 32 bytes back shifts out), so a thread that starts from h = 0 at
// the 31 bytes before its first position has h exactly after them, at one
// shift-add per byte.  One thread owns a run of kRunWords whole output
// words (32*kRunWords positions): 31 warm-up bytes (their fmix32 paid
// again: 31/128 of a step per position), then each position's two tests
// set bits of the run's words in registers; one masked store per word, no
// ballot.  A block first stages its bytes into shared memory with
// coalesced aligned 4-byte loads, realigned by one funnel shift (the row
// stride 31+P is odd, so the alignment is per row); the staged words sit
// in a padded layout (one spare word per run), so the threads' word reads
// hit 32 distinct banks.  Positions at or past nv still hash; only their
// bits are masked.  The gear value is fmix32 in registers: a 256-entry
// shared table cut the kernel's instructions by 40% on the card but not
// its time, half of which is the staging phase (PERF.md).  kRunWords = 4
// was chosen on the card (1, 2 and 4 timed; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 31;
constexpr int kRunWords = 4;  // output words one thread owns
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
  constexpr int M = kRunWords;
  constexpr int kRun = 8 * M;           // staged u32 words of one run
  constexpr int kSlot = kRun + 1;       // padded: one spare word per run
  constexpr int kBytes = 32 * M + kHalo;  // bytes one thread hashes
  // the block's T runs plus 31 halo bytes, rounded up to whole words
  constexpr int kWords = kThreads * kRun + 8;
  __shared__ uint32_t s[kThreads * kSlot + 8];

  const long long b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * (kThreads * 32 * M);
  const uint8_t* row = ext + b * row_stride;
  const uint8_t* row_end = row + row_stride;
  // staged word i holds ext bytes p0 + 4i .. p0 + 4i + 3 of the row (ext
  // byte e is the halo byte or the stream byte at position e - 31); words
  // whose start lies past the row read as 0 -- they only feed positions
  // past P, which are never stored.  An aligned word that holds a byte of
  // the row lies in mapped memory.
  const uintptr_t start = (uintptr_t)(row + p0);
  const unsigned shift = 8u * (unsigned)(start & 3u);
  const uint32_t* aligned = (const uint32_t*)(start & ~(uintptr_t)3u);
  for (int i = threadIdx.x; i < kWords; i += kThreads) {
    const uint32_t* w = aligned + i;
    const uint32_t lo = (const uint8_t*)w < row_end ? __ldg(w) : 0u;
    const uint32_t hi = (const uint8_t*)(w + 1) < row_end ? __ldg(w + 1) : 0u;
    s[i + i / kRun] = __funnelshift_r(lo, hi, shift);
  }
  __syncthreads();

  const int t = threadIdx.x;
  const long long p = p0 + (long long)t * (32 * M);  // first position
  if (p >= P) return;
  // thread t reads staged words t*kRun .. t*kRun + kRun + 7
  const uint32_t* mine = s + t * kSlot;
  uint32_t h = 0;
  uint32_t lw[M], sw[M];
#pragma unroll
  for (int u = 0; u < M; ++u) lw[u] = sw[u] = 0u;
#pragma unroll
  for (int j = 0; j < kRun + 8; ++j) {
    const uint32_t w = mine[j + (j >= kRun ? 1 : 0)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;  // the thread's k-th byte: ext byte p + k
      if (k < kBytes) {
        h = (h << 1) + gear((w >> (8 * i)) & 0xFFu);
        if (k >= kHalo) {  // position p + q
          const int q = k - kHalo;
          const uint32_t bit = 1u << (q & 31);
          if ((h & mask_l) == 0u) lw[q >> 5] |= bit;
          if ((h & mask_s) == 0u) sw[q >> 5] |= bit;
        }
      }
    }
  }
  const long long n = nv[b];
  const long long words = P >> 5;
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const long long pos = p + 32 * u;
    if (pos >= P) break;  // a run may pass the row's end (P % 32M != 0)
    const long long left = n - pos;
    const uint32_t valid = left <= 0 ? 0u
                           : left >= 32 ? 0xFFFFFFFFu
                                        : (1u << left) - 1u;
    const long long w = b * words + (pos >> 5);
    wl[w] = lw[u] & valid;
    ws[w] = lw[u] & sw[u] & valid;
  }
}

}  // namespace

extern "C" int bkw_scan_candidates(const void* ext, const void* nv, void* wl,
                                   void* ws, int B, long long P,
                                   unsigned int mask_s, unsigned int mask_l,
                                   void* stream) {
  if (B <= 0 || B > 65535 || P <= 0 || (P % 32) != 0)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * 32 * kRunWords;
  const long long blocks = (P + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)B);
  scan_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ext, (const int32_t*)nv, (uint32_t*)wl, (uint32_t*)ws,
      (long long)kHalo + P, P, (uint32_t)mask_s, (uint32_t)mask_l);
  return (int)cudaGetLastError();
}
