// Native CPU Keccak-256 for the host runtime.
//
// Plays the role of golang.org/x/crypto/sha3's assembly keccak in the
// reference (coreth trie/hasher.go:34,51): the fast host-side hashing
// path used for secure-key hashing, the recursive CPU hasher and the
// independent root oracle. Exposes single-shot, batched, and
// threaded-batched (the reference fans out 16 goroutines,
// trie/hasher.go:124-139) entry points over a C ABI for ctypes.
//
// Build: native/__init__.py (g++ -O3 -march=native -shared -fPIC ... -lpthread)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

#include "mpt_pool.h"

namespace {

constexpr int kRate = 136;

constexpr uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rotl(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

void keccakf(uint64_t a[25]) {
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];

    static constexpr int kRot[25] = {0, 1,  62, 28, 27, 36, 44, 6,  55, 20, 3, 10, 43,
                                     25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], kRot[x + 5 * y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= kRC[round];
  }
}

void keccak256_one(const uint8_t* data, uint64_t len, uint8_t* out) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  // full blocks
  while (len >= kRate) {
    for (int i = 0; i < kRate / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, data + 8 * i, 8);
      st[i] ^= w;  // little-endian host assumed
    }
    keccakf(st);
    data += kRate;
    len -= kRate;
  }
  // final (padded) block
  uint8_t last[kRate];
  std::memset(last, 0, sizeof(last));
  std::memcpy(last, data, len);
  last[len] ^= 0x01;
  last[kRate - 1] ^= 0x80;
  for (int i = 0; i < kRate / 8; ++i) {
    uint64_t w;
    std::memcpy(&w, last + 8 * i, 8);
    st[i] ^= w;
  }
  keccakf(st);
  std::memcpy(out, st, 32);
}

}  // namespace

extern "C" {

void keccak256(const uint8_t* data, uint64_t len, uint8_t* out) {
  keccak256_one(data, len, out);
}

// Hash n messages stored back-to-back; offsets has n+1 entries.
void keccak256_batch(const uint8_t* data, const uint64_t* offsets, uint64_t n,
                     uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    keccak256_one(data + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
}

// Same, fanned out over `threads` std::threads with strided work split
// (mirrors core/sender_cacher.go's strided split and trie/hasher.go's 16-way
// fan-out in the reference).
void keccak256_batch_mt(const uint8_t* data, const uint64_t* offsets, uint64_t n,
                        uint8_t* out, int threads) {
  if (threads <= 1 || n < 64) {
    keccak256_batch(data, offsets, n, out);
    return;
  }
  // pooled fan-out (mpt_pool.h): parked workers instead of per-batch
  // thread spawns — the spawn cost used to dominate below ~1k messages
  mptp::parallel(threads, [&](int t, int nt) {
    for (uint64_t i = (uint64_t)t; i < n; i += (uint64_t)nt)
      keccak256_one(data + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
  });
}

// Default worker fan-out for the batched/threaded entry points:
// CORETH_TPU_CPU_THREADS override, else min(16, hardware_concurrency)
// — exported so the Python side and the C side agree on one policy.
int keccak_default_threads() { return mptp::default_threads(); }

}  // extern "C"
