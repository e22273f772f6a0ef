// GF(2^8) matrix product over a batch of Reed-Solomon stripes for Hopper
// (sm_90a): out[b, i, l] = XOR_j mat[i, j] * in[b, j, l], all uint8, with
// mat (r, J), in (B, J, L) and out (B, r, L), each row-major and packed.
//
// Replaces backuwup_tpu/erasure/rs_tpu.py _matmul_batched, an XLA program
// (jit(vmap)) that gathers MUL_TABLE[mat[i, j], shard[j, l]] over int32
// (r, J, L) indices and XOR-reduces over j.  Materialising that gather is
// what XLA needs; an SM has a per-lane table lookup (shared memory), so
// the product is one lookup and one XOR per (output byte, input row) and
// nothing between the input and the output touches device memory.
//
// Bound on an H100: bytes.  Each input byte is read once and each output
// byte written once: RS(4, 2) encode of 64 stripes of 4 x 4 MiB moves
// 1 GiB in and 512 MiB out, ~0.48 ms at 3.35 TB/s; decode of the same
// batch 1 GiB each way, ~0.64 ms.  The lookups are r * J shared-memory
// loads per column (8 for encode, 16 for decode), under the bytes at the
// card's shared-memory rate but not far under it (PERF.md).
//
// Design: each block first builds its product table in shared memory,
// computing every entry with the shift-and-add multiply mod 0x11d (no
// table is passed in):
//  * rows path (r * J <= 256, RS(4, 2) and every geometry up to 16 x 16):
//    the r * J rows of 256 B that mat selects, row (i, j) = mat[i, j] * x;
//  * full path (r * J > 256): the whole 64 KiB product table, indexed by
//    mat[i, j] read through the read-only cache (one address per warp).
// Both need the dynamic shared memory opt-in above 48 KiB.  Then the block
// walks (stripe, 16-byte column) units grid-stride.  A thread loads 16
// bytes of each input row (one 16-byte load where the row address is
// aligned, else five aligned words and a funnel shift, so any L takes one
// path), looks each byte up and XORs into up to kRowTile output rows held
// in registers, and stores 16 bytes per output row (one 16-byte store
// where aligned, else aligned words inside the row plus single bytes at
// its edges).  A column unit at the end of a row (L % 16 != 0, including
// L == 1) handles its n < 16 bytes on the same path: the lanes past the
// row read neighbouring bytes and are never stored.  With r <= kRowTile
// (every RS geometry with r <= 8) each input byte is read once; larger r
// re-reads the inputs once per tile of output rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;       // output rows accumulated per pass
constexpr int kMaxPairRows = 256;  // rows path: r * J tables of 256 B
constexpr int kFullTable = 256 * 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0u;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    p ^= (b & 1u) ? a : 0u;
    b >>= 1;
    a = (a << 1) ^ ((a & 0x80u) ? 0x11Du : 0u);
  }
  return p;
}

__device__ __forceinline__ uint32_t look4(const uint8_t* t, uint32_t w) {
  return (uint32_t)t[w & 0xFFu] | ((uint32_t)t[(w >> 8) & 0xFFu] << 8) |
         ((uint32_t)t[(w >> 16) & 0xFFu] << 16) |
         ((uint32_t)t[w >> 24] << 24);
}

// 16 bytes from p (little-endian words).  Bytes at or past row_end are
// unspecified; no word that starts at or past row_end is read, and every
// word read starts inside the allocation (aligned down from a valid byte).
__device__ __forceinline__ uint4 load16(const uint8_t* p,
                                        const uint8_t* row_end) {
  const uintptr_t a = (uintptr_t)p;
  if ((a & 15u) == 0u && p + 16 <= row_end) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3u);
  const unsigned sh = 8u * (unsigned)(a & 3u);
  uint32_t v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    v[k] = (const uint8_t*)(w + k) < row_end ? __ldg(w + k) : 0u;
  }
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

__device__ __forceinline__ void store_word(uint8_t* base, int t0, int n,
                                           uint32_t w) {
  // the aligned word holding bytes t0 .. t0 + 3 of this unit
  if (t0 >= 0 && t0 + 4 <= n) {
    *reinterpret_cast<uint32_t*>(base + t0) = w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = t0 + q;
    if (t >= 0 && t < n) base[t] = (uint8_t)(w >> (8 * q));
  }
}

// The first n (1..16) bytes of v to p; no byte past them is written.
__device__ __forceinline__ void store16(uint8_t* p, uint4 v, int n) {
  const uintptr_t a = (uintptr_t)p;
  if ((a & 15u) == 0u && n == 16) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const int sh = (int)(a & 3u);
  const unsigned s = 8u * (unsigned)sh;
  // aligned word k covers bytes 4k - sh .. 4k - sh + 3 of the unit
  store_word(p, -sh, n, __funnelshift_l(0u, v.x, s));
  store_word(p, 4 - sh, n, __funnelshift_l(v.x, v.y, s));
  store_word(p, 8 - sh, n, __funnelshift_l(v.y, v.z, s));
  store_word(p, 12 - sh, n, __funnelshift_l(v.z, v.w, s));
  if (sh != 0) store_word(p, 16 - sh, n, __funnelshift_l(v.w, 0u, s));
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ mat,
                 const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int r, int nj, long long nb, long long len) {
  extern __shared__ __align__(16) uint8_t tab[];
  // build the table four entries (one 32-bit word) per step
  const int words = (kFull ? kFullTable : r * nj * 256) / 4;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const uint32_t a = kFull ? (uint32_t)(e >> 6) : (uint32_t)mat[e >> 6];
    const uint32_t x = (uint32_t)(e & 63) * 4u;
    reinterpret_cast<uint32_t*>(tab)[e] =
        gf_mul(a, x) | (gf_mul(a, x + 1u) << 8) | (gf_mul(a, x + 2u) << 16) |
        (gf_mul(a, x + 3u) << 24);
  }
  __syncthreads();

  const long long chunks = (len + 15) / 16;  // 16-byte column units a row
  const long long units = nb * chunks;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
       u < units; u += (long long)gridDim.x * kThreads) {
    const long long b = u / chunks;
    const long long c = (u - b * chunks) * 16;
    const int n = (int)(len - c < 16 ? len - c : 16);
    for (int i0 = 0; i0 < r; i0 += kRowTile) {
      uint4 acc[kRowTile];
#pragma unroll
      for (int q = 0; q < kRowTile; ++q) acc[q] = make_uint4(0u, 0u, 0u, 0u);
      for (int j = 0; j < nj; ++j) {
        const uint8_t* row = in + (b * nj + j) * len;
        const uint4 x = load16(row + c, row + len);
#pragma unroll
        for (int q = 0; q < kRowTile; ++q) {
          const int i = i0 + q;
          if (i < r) {  // uniform across the block
            const int sel = i * nj + j;
            const uint8_t* t =
                tab + (kFull ? ((int)__ldg(mat + sel) << 8) : (sel << 8));
            acc[q].x ^= look4(t, x.x);
            acc[q].y ^= look4(t, x.y);
            acc[q].z ^= look4(t, x.z);
            acc[q].w ^= look4(t, x.w);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRowTile; ++q) {
        const int i = i0 + q;
        if (i < r) store16(out + (b * r + i) * len + c, acc[q], n);
      }
    }
  }
}

}  // namespace

extern "C" int bkw_gf_matmul(const void* mat, const void* in, void* out,
                             int r, int nj, long long nb, long long len,
                             void* stream) {
  if (r < 1 || r > 256 || nj < 1 || nj > 256 || nb < 1 || len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool full = r * nj > kMaxPairRows;
  const int smem = full ? kFullTable : r * nj * 256;
  cudaError_t err = full
      ? cudaFuncSetAttribute(gf_matmul_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaFuncSetAttribute(gf_matmul_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return (int)err;
  }
  const long long units = nb * ((len + 15) / 16);
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (full) {
    gf_matmul_kernel<true><<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)mat, (const uint8_t*)in, (uint8_t*)out, r, nj, nb,
        len);
  } else {
    gf_matmul_kernel<false><<<(unsigned)blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)mat, (const uint8_t*)in, (uint8_t*)out, r, nj, nb,
        len);
  }
  return (int)cudaGetLastError();
}
