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
// Design: two kernels on the two permutations of keccak_f.cuh, each with a
// plain loop over the L blocks, reading each lane's 34 words per block
// straight from the [P, L, 34] layout, with no transpose: every 128-byte
// line a warp touches is used in full over the 34 loads (through L1), so
// each input byte comes from device memory once, and a transpose to the
// TPU wrapper's lane-minor [L, 34, P] would add a whole extra pass.
// - segment_keccak_kernel, one thread per lane, for wide segments (a
//   genesis commit's big segments: about 1.5M lanes over 40 segments). The
//   25 64-bit state lanes live in registers for all L blocks (ptxas for
//   sm_90a: 72 registers a thread, no spill stores), 128-thread blocks.
// - segment_keccak_coop_kernel, five threads of one warp per lane (six
//   lanes a warp, one warp a block), for narrow segments (a block
//   commit's average about 330 lanes), which one thread per lane leaves on
//   a few SMs at one thread's latency per permutation.
// segment_keccak_launch picks the kernel from the lane count alone
// (kCoopMaxLanes below), or runs the one the caller forces.
//
// What bounds it on an H100: integer-ALU throughput when a segment fills
// the card, not memory. One block is one Keccak-f[1600] plus a 17-lane
// absorb. Counted in 32-bit ALU operations with Hopper's 3-input LOP3
// folding XOR chains and chi's and-not-xor, a round is 180 ops (theta 80,
// rho 48, chi 50, iota 2), so a block is 24*180 + 34 = 4354 ops, against
// 136 bytes read. At 64 integer ops per clock per SM (132 SMs, 1.98 GHz:
// 16.7 Tops/s) that is 0.26 ns per lane-block, against 136 B / 3.35 TB/s =
// 0.041 ns: operations bound by about 6x. A narrow segment is bound by one
// permutation's latency instead: 24 rounds of dependent operations, which
// the cooperative kernel splits five ways at the cost of a shuffle and a
// shared-memory round trip a round.

#include <cuda_runtime.h>

#include <cstdint>

#include "keccak_f.cuh"

namespace {

constexpr int kThreads = 128;
// One warp a block, so that a small batch's warps land on as many SMs
// as there are warps: warps on one SM share its shared-memory pipe,
// which each round's 20 tile accesses per thread keep busy.
constexpr int kCoopWarps = 1;
constexpr int kCoopLanesPerBlock = kCoopWarps * kCoopGroupsPerWarp;

// Segments of up to this many lanes take the cooperative kernel when the
// caller lets the launch choose. Set from chip_smoke.py's variant sweep
// (phase_sweep; NVIDIA H100 80GB HBM3, 700.00 W): kernel time in the
// profiler's trace, us per launch, one thread per lane / cooperative,
// every lane absorbing L blocks:
//        B              L=1              L=4
//      128        6.9 / 4.6      24.1 / 13.9
//     1024        6.9 / 4.8      23.8 / 14.4
//     2048        7.0 / 5.2      24.0 / 15.6
//     4096        8.5 / 7.2      30.5 / 22.6
//     8192       8.6 / 10.8      30.7 / 36.2
//    65536      25.5 / 63.3     99.6 / 244.8
//   524288    166.1 / 486.6   710.3 / 1930.0
// The cooperative kernel is faster up to 4,096 lanes and slower from
// 8,192, at both L.
constexpr long long kCoopMaxLanes = 4096;

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
    absorb_block(a, w);
    keccak_f1600(a);
    w += kWordsPerBlock;
  }
  // 32 digest bytes per lane; out rows are 32-byte aligned
  store_digest(out + lane * 8, a);
}

__global__ void __launch_bounds__(kCoopWarps * 32)
segment_keccak_coop_kernel(const uint32_t* __restrict__ words,
                           uint32_t* __restrict__ out, long long p,
                           int blocks) {
  __shared__ uint64_t tiles[kCoopLanesPerBlock][kCoopTileLanes];
  const int warp = threadIdx.x / 32;
  const int group = (threadIdx.x % 32) / 5;
  if (group >= kCoopGroupsPerWarp) return;  // the warp's two idle threads
  const int slot = warp * kCoopGroupsPerWarp + group;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kCoopLanesPerBlock + slot;
  if (lane >= p) return;  // the whole group leaves together
  const CoopThread t(group, threadIdx.x % 32 - 5 * group);
  const uint32_t* w =
      words + lane * static_cast<long long>(blocks) * kWordsPerBlock;
  uint64_t a[5] = {0, 0, 0, 0, 0};
  for (int j = 0; j < blocks; ++j) {
    absorb_block_coop(a, w, t.x);
    keccak_f1600_coop(a, tiles[slot], t);
    w += kWordsPerBlock;
  }
  store_digest_coop(out + lane * 8, a, t.x);
}

}  // namespace

extern "C" {

// words: uint32[p, blocks, 34] contiguous; out: uint32[p, 8] contiguous,
// 16-byte aligned. variant: 0 chooses by p (kCoopMaxLanes), 1 forces one
// thread per lane, 2 the cooperative kernel. Launches on `stream` and does
// not synchronise. Returns the variant it launched (1 or 2), 0 when p <= 0
// leaves nothing to launch, or minus the CUDA error.
int segment_keccak_launch(const void* words, void* out, long long p,
                          int blocks, int variant, void* stream) {
  if (variant < 0 || variant > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0) return 0;
  if (variant == 0) variant = p <= kCoopMaxLanes ? 2 : 1;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    const long long grid = (p + kCoopLanesPerBlock - 1) / kCoopLanesPerBlock;
    segment_keccak_coop_kernel<<<static_cast<unsigned>(grid),
                                 kCoopWarps * 32, 0, s>>>(w, o, p, blocks);
  } else {
    const long long grid = (p + kThreads - 1) / kThreads;
    segment_keccak_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        w, o, p, blocks);
  }
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? variant : -static_cast<int>(err);
}

long long segment_keccak_coop_max_lanes() { return kCoopMaxLanes; }

}  // extern "C"
