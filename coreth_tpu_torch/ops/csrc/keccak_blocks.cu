// K2: Keccak-256 of B variable-length messages, for Hopper (sm_90a).
//
// Replaces the TPU kernel coreth_tpu/ops/keccak_pallas.py:126
// keccak256_blocks_pallas (body _make_kernel at :99, per-block step
// _absorb_permute_snapshot at :83, dispatch pallas_impl at :158).
// Contract, as there: uint32[B, L, 34] pre-padded little-endian rate blocks
// plus int32[B] nblocks in, uint32[B, 8] out (lo/hi words of state lanes
// 0-3). Lane i's digest is the state after its first nblocks[i]
// permutations. The TPU kernel masks: it permutes every lane L times,
// XORing in zeros past nblocks[i], and snapshots the digest at
// j == nblocks[i] - 1, so a lane with nblocks[i] <= 0 or > L is never
// snapshotted and its digest stays all zeros. K2 gives the same bits: the
// block loop stops after nblocks[i] permutations instead of masking, and a
// lane whose count is out of [1, L] writes zeros. Unlike the TPU kernel it
// takes any B >= 0 and any L >= 1; the TPU's B % 1024 restriction does not
// carry over.
//
// Design: two kernels on the two permutations of keccak_f.cuh, both with a
// runtime loop over the lane's own block count and words read straight
// from the [B, L, 34] layout through the read-only cache.
// - keccak_blocks_kernel, one thread per lane, for wide batches.
// - keccak_blocks_coop_kernel, five threads of one warp per lane (six lanes
//   a warp, one warp a block), for the small batches the level walk
//   sends: most of a genesis commit's buckets hold <= 1,024 lanes, which
//   one thread per lane puts on at most 8 of 132 SMs, each thread at about
//   6.4 us a block. The five threads share the lane's count, so a group
//   never diverges.
// keccak_blocks_launch picks the kernel from the lane count alone
// (kCoopMaxLanes below), or runs the one the caller forces.
//
// What bounds it on an H100: the card's integer-ALU throughput when a
// batch fills it, about 4,354 32-bit operations a block (24 rounds x 180
// with LOP3 folding, plus the 34-word absorb; segment_keccak.cu's header
// counts them) against 136 bytes read, so the operations take about 6x the
// memory time. The work is counted over the blocks the lanes really
// absorb, sum(nblocks[i]) for the lanes in range, not B x L. A small batch
// is bound instead by one permutation's latency on the critical path: 24
// rounds of dependent operations, which the cooperative kernel splits
// five ways at the cost of a shuffle and a shared-memory round trip a
// round. Lanes of one batch differ in block count (a level's branch nodes
// take 3-4 blocks, its short nodes 1-2, in one bucket of 4), so a warp
// runs as long as its longest lane while the shorter ones idle, in both
// kernels.

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

// Batches of up to this many lanes take the cooperative kernel when the
// caller lets the launch choose. Set from chip_smoke.py's variant sweep
// (phase_sweep; NVIDIA H100 80GB HBM3, 700.00 W): kernel time in the
// profiler's trace, us per launch, one thread per lane / cooperative,
// every lane absorbing L blocks:
//        B              L=1              L=4
//      128        6.9 / 4.7      22.3 / 13.1
//     1024        7.0 / 4.9      25.2 / 15.3
//     2048        6.9 / 5.2      24.0 / 15.8
//     4096        8.1 / 6.9      30.3 / 22.6
//     8192       8.6 / 10.7      30.6 / 36.1
//    65536      24.4 / 63.1     89.6 / 246.4
//   524288    167.8 / 486.7   701.9 / 1918.3
// The cooperative kernel is faster up to 4,096 lanes and slower from
// 8,192, at both L.
constexpr long long kCoopMaxLanes = 4096;

__global__ void __launch_bounds__(kThreads)
keccak_blocks_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ nblocks,
                     uint32_t* __restrict__ out, long long b, int blocks) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= b) return;
  const int nb = nblocks[lane];
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  if (nb >= 1 && nb <= blocks) {
    const uint32_t* w =
        words + lane * static_cast<long long>(blocks) * kWordsPerBlock;
    for (int j = 0; j < nb; ++j) {
      absorb_block(a, w);
      keccak_f1600(a);
      w += kWordsPerBlock;
    }
  }
  // out of range: the all-zero state's lanes 0-3, i.e. a zero digest
  store_digest(out + lane * 8, a);
}

__global__ void __launch_bounds__(kCoopWarps * 32)
keccak_blocks_coop_kernel(const uint32_t* __restrict__ words,
                          const int32_t* __restrict__ nblocks,
                          uint32_t* __restrict__ out, long long b,
                          int blocks) {
  __shared__ uint64_t tiles[kCoopLanesPerBlock][kCoopTileLanes];
  const int warp = threadIdx.x / 32;
  const int group = (threadIdx.x % 32) / 5;
  if (group >= kCoopGroupsPerWarp) return;  // the warp's two idle threads
  const int slot = warp * kCoopGroupsPerWarp + group;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kCoopLanesPerBlock + slot;
  if (lane >= b) return;  // the whole group leaves together
  const CoopThread t(group, threadIdx.x % 32 - 5 * group);
  const int nb = nblocks[lane];  // the same count for the group's five
  uint64_t a[5] = {0, 0, 0, 0, 0};
  if (nb >= 1 && nb <= blocks) {
    const uint32_t* w =
        words + lane * static_cast<long long>(blocks) * kWordsPerBlock;
    for (int j = 0; j < nb; ++j) {
      absorb_block_coop(a, w, t.x);
      keccak_f1600_coop(a, tiles[slot], t);
      w += kWordsPerBlock;
    }
  }
  // out of range: the all-zero state's lanes 0-3, i.e. a zero digest
  store_digest_coop(out + lane * 8, a, t.x);
}

}  // namespace

extern "C" {

// words: uint32[b, blocks, 34] contiguous; nblocks: int32[b]; out:
// uint32[b, 8] contiguous, 16-byte aligned. variant: 0 chooses by b
// (kCoopMaxLanes), 1 forces one thread per lane, 2 the cooperative kernel.
// Launches on `stream` and does not synchronise. Returns the variant it
// launched (1 or 2), 0 when b <= 0 leaves nothing to launch, or minus the
// CUDA error.
int keccak_blocks_launch(const void* words, const void* nblocks, void* out,
                         long long b, int blocks, int variant,
                         void* stream) {
  if (variant < 0 || variant > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  if (variant == 0) variant = b <= kCoopMaxLanes ? 2 : 1;
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* n = static_cast<const int32_t*>(nblocks);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    const long long grid = (b + kCoopLanesPerBlock - 1) / kCoopLanesPerBlock;
    keccak_blocks_coop_kernel<<<static_cast<unsigned>(grid), kCoopWarps * 32,
                                0, s>>>(w, n, o, b, blocks);
  } else {
    const long long grid = (b + kThreads - 1) / kThreads;
    keccak_blocks_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        w, n, o, b, blocks);
  }
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? variant : -static_cast<int>(err);
}

long long keccak_blocks_coop_max_lanes() { return kCoopMaxLanes; }

}  // extern "C"
