// Keccak-f[1600] for Hopper, shared by kernels K1 (segment_keccak.cu) and
// K2 (keccak_blocks.cu).
//
// The 25 64-bit state lanes live in registers; the 24 rounds are unrolled;
// a 64-bit rotate is two 32-bit funnel shifts (SHF) with immediate shift
// counts. Input blocks are 34 little-endian u32 words (136 bytes, one rate
// block); the digest is the lo/hi words of state lanes 0-3.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWordsPerBlock = 34;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

// 64-bit rotate left by a compile-time N as two 32-bit funnel shifts.
// __funnelshift_l(lo, hi, s) returns the top 32 bits of (hi:lo) << s.
template <int N>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  static_assert(N > 0 && N < 64, "rotation out of range");
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  uint32_t nlo, nhi;
  if constexpr (N < 32) {
    nhi = __funnelshift_l(lo, hi, N);
    nlo = __funnelshift_l(hi, lo, N);
  } else if constexpr (N == 32) {
    nhi = lo;
    nlo = hi;
  } else {
    nhi = __funnelshift_l(hi, lo, N - 32);
    nlo = __funnelshift_l(lo, hi, N - 32);
  }
  return (static_cast<uint64_t>(nhi) << 32) | nlo;
}

__device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], r[x][y])
    b[0] = a[0];
    b[16] = rotl<36>(a[5]);
    b[7] = rotl<3>(a[10]);
    b[23] = rotl<41>(a[15]);
    b[14] = rotl<18>(a[20]);
    b[10] = rotl<1>(a[1]);
    b[1] = rotl<44>(a[6]);
    b[17] = rotl<10>(a[11]);
    b[8] = rotl<45>(a[16]);
    b[24] = rotl<2>(a[21]);
    b[20] = rotl<62>(a[2]);
    b[11] = rotl<6>(a[7]);
    b[2] = rotl<43>(a[12]);
    b[18] = rotl<15>(a[17]);
    b[9] = rotl<61>(a[22]);
    b[5] = rotl<28>(a[3]);
    b[21] = rotl<55>(a[8]);
    b[12] = rotl<25>(a[13]);
    b[3] = rotl<21>(a[18]);
    b[19] = rotl<56>(a[23]);
    b[15] = rotl<27>(a[4]);
    b[6] = rotl<20>(a[9]);
    b[22] = rotl<39>(a[14]);
    b[13] = rotl<8>(a[19]);
    b[4] = rotl<14>(a[24]);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    // iota
    a[0] ^= kRC[r];
  }
}

// XOR one 136-byte rate block (34 u32 words, read through the read-only
// cache) into state lanes 0-16.
__device__ __forceinline__ void absorb_block(uint64_t a[25],
                                             const uint32_t* __restrict__ w) {
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const uint32_t lo = __ldg(w + 2 * i);
    const uint32_t hi = __ldg(w + 2 * i + 1);
    a[i] ^= (static_cast<uint64_t>(hi) << 32) | lo;
  }
}

// Write the 32 digest bytes (lo/hi of lanes 0-3) to a 16-byte aligned row.
__device__ __forceinline__ void store_digest(uint32_t* out,
                                             const uint64_t a[25]) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(static_cast<uint32_t>(a[0]),
                    static_cast<uint32_t>(a[0] >> 32),
                    static_cast<uint32_t>(a[1]),
                    static_cast<uint32_t>(a[1] >> 32));
  o[1] = make_uint4(static_cast<uint32_t>(a[2]),
                    static_cast<uint32_t>(a[2] >> 32),
                    static_cast<uint32_t>(a[3]),
                    static_cast<uint32_t>(a[3] >> 32));
}

}  // namespace
