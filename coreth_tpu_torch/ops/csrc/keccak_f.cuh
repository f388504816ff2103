// Keccak-f[1600] for Hopper, shared by kernels K1 (segment_keccak.cu) and
// K2 (keccak_blocks.cu), in two forms. Input blocks are 34 little-endian
// u32 words (136 bytes, one rate block); the digest is the lo/hi words of
// state lanes 0-3.
//
// One thread per state (keccak_f1600): the 25 64-bit state lanes live in
// registers; the 24 rounds are unrolled; a 64-bit rotate is two 32-bit
// funnel shifts (SHF) with immediate shift counts. One thread carries all
// ~4,354 dependent 32-bit operations of a block, so a batch too small to
// fill the card runs at one thread's latency (about 6.4 us a block on an
// H100). This form is for wide batches, where the card's integer
// throughput bounds it.
//
// Five threads per state (keccak_f1600_coop): thread x of a group of five
// in one warp owns column x, lanes a[x + 5y] for y = 0..4, in 10
// registers; six groups share a warp and its last two threads idle. Per
// round: theta's column parity is thread-local and D[x] takes the
// neighbours' parities by two 64-bit shuffles inside the group; rho rotates
// by the column's five counts (kCoopRho) held in registers; pi stores the
// five rotated lanes into the group's shared-memory tile at kCoopPi
// (a layout chosen against bank conflicts, below); after a __syncwarp,
// chi reads three lanes of each of its five rows back; iota runs on
// thread 0. The shuffles and the __syncwarp name the group's five lanes
// alone, so a group leaves its loop after its own lane's last block while
// the warp's other groups go on. About a third of the single-thread
// operations sit on each thread's critical path, plus one shuffle and one
// shared-memory round trip per round. What bounds it is that round's
// latency, the shuffle's and the shared-memory exchange's above all (an
// H100 runs a cooperative block in about 3.1 us, one thread's in 6.4). So
// it is for batches that leave the card idle; on a wide batch the SM's
// shared-memory throughput bounds it, its five threads do more work in all
// than one thread does, and the one-thread form wins.

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

// ------------------------------------------ five threads per state (coop)

constexpr int kCoopGroupsPerWarp = 6;  // 6 x 5 = 30 threads; 2 idle
// A group's shared tile holds pi's output B, lane (X, Y) at X +
// kCoopRowLanes * Y, in two buffers used in alternate rounds, so that one
// __syncwarp a round orders both pi's stores and chi's loads. The layout
// is chosen against bank conflicts (64-bit accesses are served a half-warp
// at a time, 16 threads over 32 four-byte banks):
// - groups start 133 lanes (266 words, 10 banks mod 32) apart, so when
//   thread x of every group reads row Y at column x, as chi's first load
//   does, a half-warp hits 32 different banks; at columns x + 1 and x + 2
//   only the first half-warp's one thread of group 3 shares a bank (two
//   ways);
// - rows are 15 lanes (30 words, -2 banks mod 32) apart, so pi's stores,
//   which send a thread's five lanes to five rows of one column, collide
//   at most two ways.
// Each round a thread makes 5 stores and 15 loads to the tile.
// (tests/test_torch_keccak_coop.py checks these bounds.)
constexpr int kCoopRowLanes = 15;
constexpr int kCoopBufLanes = 4 * kCoopRowLanes + 5;  // 65
constexpr int kCoopTileLanes = 2 * kCoopBufLanes + 3;  // 133

// rho's rotation count of lane x + 5y, by column: kCoopRho[x][y].
__constant__ int kCoopRho[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14}};

// pi's destination of lane x + 5y in the tile: B's lane (X, Y) = (y,
// (2x + 3y) % 5), so kCoopPi[x][y] = y + kCoopRowLanes * ((2x + 3y) % 5).
__constant__ int kCoopPi[5][5] = {
    {0, 46, 17, 63, 34},
    {30, 1, 47, 18, 64},
    {60, 31, 2, 48, 19},
    {15, 61, 32, 3, 49},
    {45, 16, 62, 33, 4}};

// 64-bit rotate left by a runtime count n in [0, 63]: __funnelshift_l
// shifts by n & 31, and n >= 32 swaps the two halves.
__device__ __forceinline__ uint64_t rotl_var(uint64_t v, int n) {
  const uint32_t lo = static_cast<uint32_t>(v);
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  const uint32_t t1 = __funnelshift_l(lo, hi, n);
  const uint32_t t2 = __funnelshift_l(hi, lo, n);
  const bool wide = n >= 32;
  return (static_cast<uint64_t>(wide ? t2 : t1) << 32) | (wide ? t1 : t2);
}

// What one thread of a group knows about its place, read once per kernel.
struct CoopThread {
  int x;           // the column this thread owns
  unsigned mask;   // the group's five lanes of the warp
  int prev, next;  // warp lanes of columns x - 1 and x + 1
  int x1, x2;      // columns (x + 1) % 5 and (x + 2) % 5
  int rho[5];
  int pi[5];

  __device__ __forceinline__ CoopThread(int group, int col) : x(col) {
    const int base = 5 * group;
    mask = 0x1fu << base;
    prev = base + (x + 4) % 5;
    next = base + (x + 1) % 5;
    x1 = (x + 1) % 5;
    x2 = (x + 2) % 5;
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      rho[y] = kCoopRho[x][y];
      pi[y] = kCoopPi[x][y];
    }
  }
};

// One Keccak-f[1600] over the group's state; a[y] is lane x + 5y. All five
// threads of the group call it together; `tile` is the group's own
// kCoopTileLanes lanes of shared memory.
__device__ __forceinline__ void keccak_f1600_coop(uint64_t a[5],
                                                  uint64_t* tile,
                                                  const CoopThread& t) {
  constexpr int R = kCoopRowLanes;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    uint64_t* b = tile + (r & 1) * kCoopBufLanes;
    // theta
    const unsigned long long c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4];
    const uint64_t cp = __shfl_sync(t.mask, c, t.prev);
    const uint64_t cn = __shfl_sync(t.mask, c, t.next);
    const uint64_t d = cp ^ rotl<1>(cn);
    // rho + pi
#pragma unroll
    for (int y = 0; y < 5; ++y) b[t.pi[y]] = rotl_var(a[y] ^ d, t.rho[y]);
    __syncwarp(t.mask);
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y)
      a[y] = b[t.x + R * y] ^ (~b[t.x1 + R * y] & b[t.x2 + R * y]);
    // iota
    if (t.x == 0) a[0] ^= kRC[r];
  }
}

// XOR one rate block into the group's state: thread x takes the lanes
// x + 5y < 17, two words each.
__device__ __forceinline__ void absorb_block_coop(
    uint64_t a[5], const uint32_t* __restrict__ w, int x) {
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int i = x + 5 * y;
    if (i < 17) {
      const uint32_t lo = __ldg(w + 2 * i);
      const uint32_t hi = __ldg(w + 2 * i + 1);
      a[y] ^= (static_cast<uint64_t>(hi) << 32) | lo;
    }
  }
}

// Threads 0-3 write lane x's two digest words to an 8-byte aligned row.
__device__ __forceinline__ void store_digest_coop(uint32_t* out,
                                                  const uint64_t a[5],
                                                  int x) {
  if (x < 4)
    reinterpret_cast<uint2*>(out)[x] = make_uint2(
        static_cast<uint32_t>(a[0]), static_cast<uint32_t>(a[0] >> 32));
}

}  // namespace
