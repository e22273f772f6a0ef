// Variants of the CDC candidate scan (backuwup_tpu_torch/csrc/
// scan_candidates.cu) for a timing trial on the card; not part of the
// port.  Same staging, rolling hash, packing and output contract as the
// port's kernel, with the gear value taken three ways, plus the staging
// alone:
//   0: fmix32 in registers (the port's kernel);
//   1: one 256-entry table in shared memory (lanes meet on banks);
//   2: 32 copies of the table, one per lane, entry stride 256 B, so one
//      PRMT of the staged word and the lane's offset is the address and
//      no two lanes share a bank;
//   3: the staging phase alone (each thread stores the xor of its words).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//   -Xcompiler -fPIC (scripts/torch_k1_variants.py does it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 31;
constexpr int M = 4;
constexpr int kRun = 8 * M, kSlot = kRun + 1, kBytes = 32 * M + kHalo;
constexpr int kWords = kThreads * kRun + 8;
constexpr int kStage = kThreads * kSlot + 8;
constexpr uint32_t kGearSeed = 0x6261636Bu;

__device__ __forceinline__ uint32_t gear(uint32_t b) {
  uint32_t h = b + kGearSeed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <int Mode>
__host__ __device__ constexpr int table_words() {
  return Mode == 1 ? 256 : Mode == 2 ? 256 * 64 : 0;
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const uint8_t* __restrict__ ext, const int32_t* __restrict__ nv,
               uint32_t* __restrict__ wl, uint32_t* __restrict__ ws,
               long long row_stride, long long P, uint32_t mask_s,
               uint32_t mask_l) {
  extern __shared__ uint32_t dyn[];
  uint32_t* tab = dyn;
  uint32_t* s = dyn + table_words<Mode>();
  const int t = threadIdx.x;
  if (Mode == 1) {
    tab[t] = gear(t);
  } else if (Mode == 2) {
    tab[t * 64 + 32] = gear(t);
    __syncthreads();
    for (int k = t; k < 256 * 32; k += kThreads)
      tab[(k >> 5) * 64 + (k & 31)] = tab[(k >> 5) * 64 + 32];
  }
  const long long b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * (kThreads * 32 * M);
  const uint8_t* row = ext + b * row_stride;
  const uint8_t* row_end = row + row_stride;
  const uintptr_t start = (uintptr_t)(row + p0);
  const unsigned shift = 8u * (unsigned)(start & 3u);
  const uint32_t* aligned = (const uint32_t*)(start & ~(uintptr_t)3u);
  for (int i = t; i < kWords; i += kThreads) {
    const uint32_t* w = aligned + i;
    const uint32_t lo = (const uint8_t*)w < row_end ? __ldg(w) : 0u;
    const uint32_t hi = (const uint8_t*)(w + 1) < row_end ? __ldg(w + 1) : 0u;
    s[i + i / kRun] = __funnelshift_r(lo, hi, shift);
  }
  __syncthreads();
  const long long p = p0 + (long long)t * (32 * M);
  if (p >= P) return;
  const long long words = P >> 5;
  const uint32_t* mine = s + t * kSlot;
  if (Mode == 3) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < kSlot + 8; ++j) x ^= mine[j];
    wl[b * words + (p >> 5)] = x;
    return;
  }
  const uint32_t laneoff = 4u * (t & 31);
  uint32_t h = 0;
  uint32_t lw[M], sw[M];
#pragma unroll
  for (int u = 0; u < M; ++u) lw[u] = sw[u] = 0u;
#pragma unroll
  for (int j = 0; j < kRun + 8; ++j) {
    const uint32_t w = mine[j + (j >= kRun ? 1 : 0)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;
      if (k < kBytes) {
        uint32_t g;
        if (Mode == 0) {
          g = gear((w >> (8 * i)) & 0xFFu);
        } else if (Mode == 1) {
          g = tab[(w >> (8 * i)) & 0xFFu];
        } else {  // byte i of w to bits 8-15, the lane's offset to 0-7
          const uint32_t off = __byte_perm(w, laneoff, 0x5504u | (i << 4));
          g = *(const uint32_t*)((const char*)tab + off);
        }
        h = (h << 1) + g;
        if (k >= kHalo) {
          const int q = k - kHalo;
          const uint32_t bit = 1u << (q & 31);
          if ((h & mask_l) == 0u) lw[q >> 5] |= bit;
          if ((h & mask_s) == 0u) sw[q >> 5] |= bit;
        }
      }
    }
  }
  const long long n = nv[b];
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const long long pos = p + 32 * u;
    if (pos >= P) break;
    const long long left = n - pos;
    const uint32_t valid = left <= 0 ? 0u
                           : left >= 32 ? 0xFFFFFFFFu
                                        : (1u << left) - 1u;
    const long long w = b * words + (pos >> 5);
    wl[w] = lw[u] & valid;
    ws[w] = lw[u] & sw[u] & valid;
  }
}

template <int Mode>
int launch(const void* ext, const void* nv, void* wl, void* ws, int B,
           long long P, unsigned mask_s, unsigned mask_l, void* stream) {
  const int smem = (table_words<Mode>() + kStage) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      variant_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)kThreads * 32 * M;
  dim3 grid((unsigned)((P + per_block - 1) / per_block), (unsigned)B);
  variant_kernel<Mode><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)ext, (const int32_t*)nv, (uint32_t*)wl, (uint32_t*)ws,
      (long long)kHalo + P, P, mask_s, mask_l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bkw_scan_variant(int mode, const void* ext, const void* nv,
                                void* wl, void* ws, int B, long long P,
                                unsigned mask_s, unsigned mask_l,
                                void* stream) {
  if (B <= 0 || B > 65535 || P <= 0 || (P % 32) != 0)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: return launch<0>(ext, nv, wl, ws, B, P, mask_s, mask_l, stream);
    case 1: return launch<1>(ext, nv, wl, ws, B, P, mask_s, mask_l, stream);
    case 2: return launch<2>(ext, nv, wl, ws, B, P, mask_s, mask_l, stream);
    case 3: return launch<3>(ext, nv, wl, ws, B, P, mask_s, mask_l, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
