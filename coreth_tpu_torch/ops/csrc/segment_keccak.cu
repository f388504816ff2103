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
// for all L blocks; the permutation (keccak_f.cuh, shared with K2) unrolls
// its 24 rounds, and 64-bit rotates are two 32-bit funnel shifts (SHF)
// with immediate shift counts. There is a plain
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

#include "keccak_f.cuh"

namespace {

constexpr int kThreads = 128;

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
