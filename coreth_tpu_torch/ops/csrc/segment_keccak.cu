// K1: segment Keccak-256 for Hopper (sm_90a).
//
// Replaces the TPU kernel coreth_tpu/ops/keccak_pallas.py:211
// segment_keccak_pallas (body _make_segment_kernel at :172, dispatch
// staged_seg_impl at :243). Contract, as there: uint32[P, L, 34] pre-padded
// little-endian rate blocks in, uint32[P, 8] out (lo/hi words of state
// lanes 0-3). Every lane has exactly L blocks, so there is no masking: the
// digest is the state after the last permutation. Unlike the TPU kernel it
// takes any P >= 1 and any L >= 1; the TPU's P % 1024 restriction and its
// XLA-scan fallback do not carry over.
//
// Design: one thread per lane. The 25 64-bit state lanes live in registers
// for all L blocks; the 24 rounds are unrolled; 64-bit rotates are two
// 32-bit funnel shifts (SHF) with immediate shift counts. There is a plain
// loop over the L blocks. Each thread reads its own lane's 34 words per
// block straight from the [P, L, 34] layout, with no transpose: neighbouring
// threads read addresses 136*L bytes apart, but every 128-byte line a warp
// touches is used in full over the 34 loads (through L1), so the kernel
// reads each input byte from device memory once, and a transpose to the
// TPU wrapper's lane-minor [L, 34, P] would add a whole extra pass.
//
// What bounds it on an H100: integer-ALU throughput, not memory. One block
// is one Keccak-f[1600] plus a 17-lane absorb. Counted in 32-bit ALU
// operations with Hopper's 3-input LOP3 folding XOR chains and chi's
// and-not-xor, a round is 180 ops (theta 80, rho 48, chi 50, iota 2), so a
// block is 24*180 + 34 = 4354 ops, against 136 bytes read. At 64 integer
// ops per clock per SM (132 SMs, 1.98 GHz: 16.7 Tops/s) that is 0.26 ns per
// lane-block, against 136 B / 3.35 TB/s = 0.041 ns: operations bound by
// about 6x. The design does nothing but that arithmetic: no shared memory,
// no re-reads, state never spills (ptxas for sm_90a: 72 registers a thread,
// no spill stores), 128-thread blocks, and enough independent lanes per SM
// to hide the ALU latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
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

__global__ void __launch_bounds__(kThreads)
segment_keccak_kernel(const uint32_t* __restrict__ words,
                      uint32_t* __restrict__ out, long long p, int blocks) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= p) return;
  const uint32_t* w =
      words + lane * static_cast<long long>(blocks) * kWordsPerBlock;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  for (int j = 0; j < blocks; ++j) {
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      const uint32_t lo = __ldg(w + 2 * i);
      const uint32_t hi = __ldg(w + 2 * i + 1);
      a[i] ^= (static_cast<uint64_t>(hi) << 32) | lo;
    }
    keccak_f1600(a);
    w += kWordsPerBlock;
  }
  // 32 digest bytes per lane; out rows are 32-byte aligned
  uint4* o = reinterpret_cast<uint4*>(out + lane * 8);
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

extern "C" {

// words: uint32[p, blocks, 34] contiguous; out: uint32[p, 8] contiguous,
// 16-byte aligned. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
int segment_keccak_launch(const void* words, void* out, long long p,
                          int blocks, void* stream) {
  if (p <= 0) return 0;
  const long long grid = (p + kThreads - 1) / kThreads;
  segment_keccak_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), p,
      blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
