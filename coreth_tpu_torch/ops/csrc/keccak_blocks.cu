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
// Design: one thread per lane, as K1 (segment_keccak.cu): the state in
// registers, the permutation of keccak_f.cuh (24 rounds unrolled, rotates as
// funnel shifts), a runtime loop over the lane's own block count, words
// read straight from the [B, L, 34] layout through the read-only cache.
//
// What bounds it on an H100: integer-ALU throughput, as K1. A block costs
// about 4,354 32-bit operations (24 rounds x 180 with LOP3 folding, plus
// the 34-word absorb; segment_keccak.cu's header counts them) against 136
// bytes read, so the operations take about 6x the memory time. The work is
// counted over the blocks the lanes really absorb, sum(nblocks[i]) for the
// lanes in range, not B x L. Lanes of one batch differ in block count (a
// level's branch nodes take 3-4 blocks, its short nodes 1-2, in one bucket
// of 4), so a warp runs as long as its longest lane while the shorter
// lanes idle: that divergence is left in this first version.

#include <cuda_runtime.h>

#include <cstdint>

#include "keccak_f.cuh"

namespace {

constexpr int kThreads = 128;

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

}  // namespace

extern "C" {

// words: uint32[b, blocks, 34] contiguous; nblocks: int32[b]; out:
// uint32[b, 8] contiguous, 16-byte aligned. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
int keccak_blocks_launch(const void* words, const void* nblocks, void* out,
                         long long b, int blocks, void* stream) {
  if (b <= 0) return 0;
  const long long grid = (b + kThreads - 1) / kThreads;
  keccak_blocks_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out), b,
      blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
