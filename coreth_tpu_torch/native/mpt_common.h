// Shared primitives for the native MPT planners (mpt.cpp full-rebuild,
// mpt_inc.cpp incremental): keccak-f[1600] (FIPS-202), RLP writers, the
// hex-prefix compact encoding, and the segment lane-rounding policy.
// One definition each — the two planners must never drift on these.
#pragma once

#include <cstdint>
#include <cstring>

namespace mptc {

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

inline void keccakf(uint64_t a[25]) {
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    static constexpr int kRot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3, 10, 43,
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

// Hash a pre-padded message of `blocks` rate blocks living at `row`.
inline void keccak_padded(const uint8_t* row, int blocks, uint8_t* out) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  for (int b = 0; b < blocks; ++b) {
    for (int i = 0; i < kRate / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, row + b * kRate + 8 * i, 8);
      st[i] ^= w;
    }
    keccakf(st);
  }
  std::memcpy(out, st, 32);
}

// ---- RLP ------------------------------------------------------------------

inline int bytes_enc_len(const uint8_t* b, int n) {
  if (n == 1 && b[0] < 0x80) return 1;
  if (n < 56) return 1 + n;
  int ll = 0;
  for (int v = n; v; v >>= 8) ++ll;
  return 1 + ll + n;
}

inline int list_hdr_len(int payload) {
  if (payload < 56) return 1;
  int ll = 0;
  for (int v = payload; v; v >>= 8) ++ll;
  return 1 + ll;
}

inline uint8_t* write_bytes(const uint8_t* b, int n, uint8_t* out) {
  if (n == 1 && b[0] < 0x80) {
    *out++ = b[0];
  } else if (n < 56) {
    *out++ = 0x80 + n;
    std::memcpy(out, b, n);
    out += n;
  } else {
    int ll = 0;
    for (int v = n; v; v >>= 8) ++ll;
    *out++ = 0xB7 + ll;
    for (int i = ll - 1; i >= 0; --i) *out++ = (n >> (8 * i)) & 0xff;
    std::memcpy(out, b, n);
    out += n;
  }
  return out;
}

inline uint8_t* write_list_hdr(int payload, uint8_t* out) {
  if (payload < 56) {
    *out++ = 0xC0 + payload;
  } else {
    int ll = 0;
    for (int v = payload; v; v >>= 8) ++ll;
    *out++ = 0xF7 + ll;
    for (int i = ll - 1; i >= 0; --i) *out++ = (payload >> (8 * i)) & 0xff;
  }
  return out;
}

// ---- hex-prefix / nibbles -------------------------------------------------

inline int nibble(const uint8_t* key32, int i) {
  uint8_t b = key32[i >> 1];
  return (i & 1) ? (b & 0xf) : (b >> 4);
}

inline int compact_len(int nnib) { return 1 + nnib / 2; }

// ---- segment lane rounding (shared with trie/planned.py's _pad_lanes) -----

inline int pow2_at_least(int v, int floor_) {
  int t = floor_;
  while (t < v) t <<= 1;
  return t;
}

inline int round_lanes(int v) {
  if (v <= 8192) return pow2_at_least(v, 16);
  return (v + 8191) / 8192 * 8192;
}

}  // namespace mptc
