// K3: the resident executor's delta patch for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It takes the place of the XLA ops that the
// reference runs inside its one whole-commit program
// (coreth_tpu/ops/keccak_resident.py:412 _fused_program: per segment,
// the two digest gathers, _strips twice and the scatter-add into the
// arena), which the port, with no compiler to fuse them, enqueued as about
// 40 small torch ops a segment from Python.
//
// Contract, one segment of one resident commit (ops/keccak_resident.py):
// for each patch i < n,
//   new = src[i] > 0 ? dig[src[i]] : store[-src[i]]   (src 0: store[0], the
//                                                      zero sentinel)
//   old = store[oldidx[i]]
// both 8-word digests (u32 bits) are laid at byte shift off[i] & 3 into a
// 9-word strip, and (new_strip[j] - old_strip[j]) mod 2^32 is added to the
// class's flat arena at word (off[i] >> 2) + j, j < 9. A word outside
// [0, scratch) goes to the scratch word past the rows instead (the torch
// version's where(); JAX drops it). Indices past the store or the digest
// matrix read a zero digest rather than fault (the planner never makes
// them; the torch version would assert and poison the context).
//
// Design: one thread per (patch, strip word), 128-thread blocks, so that
// a segment's few hundred patches spread over as many SMs as the grid
// has blocks. Each thread reads its patch's three indices and the two
// words of each digest that its strip word draws on (through L1: the nine
// threads of a patch share two 32-byte rows), and adds with atomicAdd on
// the u32 bits: the strips of neighbouring holes in one row (33 bytes
// apart in a branch node) overlap a word, and modular addition makes the
// order of the atomics irrelevant, so the result is bit-exact whatever
// order they land in. A zero delta (pad patches, unchanged children)
// skips its atomic.
//
// What bounds it on an H100: the launch, not bytes or operations. A patch
// moves 12 B of indices, 64 B of digests and 9 words read and written in
// the arena (72 B): 148 B, so a replay segment's ~200-400 patches are
// 30-60 KB, about 10-20 ns at 3.35 TB/s, against a few microseconds of
// launch latency; the ~20 integer operations per strip word are
// negligible beside it. The design therefore spends nothing on tiling or
// shared memory: the gain over the torch chain is one launch in place of
// ~40, each of which cost the host ~20 us to enqueue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kStripWords = 9;  // 32 digest bytes at a byte shift of 0-3
constexpr int kDigestWords = 8;

// The digest row `row` of a [rows, 8] matrix, or null (a zero digest) when
// the row is out of range.
__device__ __forceinline__ const uint32_t* digest_row(const uint32_t* m,
                                                      long long rows,
                                                      long long row) {
  return row >= 0 && row < rows ? m + row * kDigestWords : nullptr;
}

// Word j of the 9-word strip of digest d laid at a byte shift of lsh / 8:
// d[j - 1]'s high bytes carried in, d[j]'s low bytes moved up (d[-1] and
// d[8] are zero). lsh == 0 is handled apart: a u32 shift by 32 is
// undefined in C.
__device__ __forceinline__ uint32_t strip_word(const uint32_t* d, int j,
                                               int lsh) {
  if (d == nullptr) return 0u;
  const uint32_t hi = j < kDigestWords ? d[j] << lsh : 0u;
  const uint32_t lo = (lsh != 0 && j > 0) ? d[j - 1] >> (32 - lsh) : 0u;
  return lo | hi;
}

__global__ void __launch_bounds__(kThreads)
resident_patch_kernel(uint32_t* __restrict__ flat, long long scratch,
                      const uint32_t* __restrict__ store, long long store_rows,
                      const uint32_t* __restrict__ dig, long long dig_rows,
                      const int32_t* __restrict__ off,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ oldidx, long long n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * kStripWords) return;
  const long long i = t / kStripWords;
  const int j = static_cast<int>(t - i * kStripWords);
  const int32_t o = off[i];
  const int32_t s = src[i];
  const uint32_t* nd =
      s > 0 ? digest_row(dig, dig_rows, s)
            : digest_row(store, store_rows, -static_cast<long long>(s));
  const uint32_t* od = digest_row(store, store_rows, oldidx[i]);
  const int lsh = 8 * (o & 3);
  const uint32_t delta = strip_word(nd, j, lsh) - strip_word(od, j, lsh);
  if (delta == 0u) return;
  long long w = static_cast<long long>(o >> 2) + j;  // o >> 2: floor, as torch
  if (w < 0 || w >= scratch) w = scratch;
  atomicAdd(flat + w, delta);
}

}  // namespace

extern "C" {

// flat: uint32[scratch + 1] contiguous, a class's arena rows flat and the
// scratch word last; store: uint32[store_rows, 8]; dig: uint32[dig_rows,
// 8]; off, src, oldidx: int32[n] each, the segment's patches (pointers
// into the commit's uploaded tables). Launches on `stream` and does not
// synchronise. Returns 1 when it launched, 0 when n <= 0 leaves nothing
// to launch, or minus the CUDA error.
int resident_patch_launch(void* flat, long long scratch, const void* store,
                          long long store_rows, const void* dig,
                          long long dig_rows, const void* off,
                          const void* src, const void* oldidx, long long n,
                          void* stream) {
  if (scratch < 0 || store_rows < 0 || dig_rows < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long grid = (n * kStripWords + kThreads - 1) / kThreads;
  resident_patch_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(flat), scratch,
      static_cast<const uint32_t*>(store), store_rows,
      static_cast<const uint32_t*>(dig), dig_rows,
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(oldidx), n);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

}  // extern "C"
