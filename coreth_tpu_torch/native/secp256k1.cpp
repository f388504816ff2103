// Batched secp256k1 public-key recovery for the sender cacher.
//
// Semantics of the cgo libsecp256k1 bridge in coreth
// (crypto/secp256k1 under core/sender_cacher.go:88-115): the chain's
// per-block hot loop recovers every tx sender; here the whole batch is
// recovered natively across a thread pool and handed back as 20-byte
// addresses (keccak of the recovered pubkey runs in-process via
// keccak.cpp's sponge, compiled into this TU).
//
// Counterpart of coreth_tpu/native/secp256k1.cpp (a copy; the port builds
// it with native/_build.py, which raises on a failed build).
//
// Implementation notes (from-scratch, no external code):
//   - field arithmetic mod p = 2^256 - 0x1000003D1 on 4x64 limbs with
//     __int128 schoolbook multiply and the special-form fold
//   - scalar arithmetic mod the group order n via iterated fold with
//     c = 2^256 - n (a 129-bit constant)
//   - Jacobian doubling/addition (standard EFD formulas), 4-bit
//     windowed double-and-add scalar multiplication
//   - inversions by Fermat exponentiation (no gcd branches)
//   - recovery follows the classic u1*G + u2*R construction with
//     Ethereum recid semantics (recid>>1 selects the high-x root)
//
// Exposed C ABI (ctypes):
//   secp_recover_batch(msgs32, sigs64, recids, n, threads,
//                      out_addrs20, out_ok) -> void
//   secp_pubkey_recover_one(msg32, sig64, recid, out_pub64) -> int

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------- keccak ---
// Minimal standalone Keccak-256 (same public constants as keccak.cpp; kept
// local so this shared object has no link-time dependency on it).
static const u64 KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline u64 rotl64(u64 x, int n) { return (x << n) | (x >> (64 - n)); }

static void keccak_f1600(u64 st[25]) {
  static const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                               27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  static const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                               15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  u64 t, bc[5];
  for (int round = 0; round < 24; round++) {
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = piln[i];
      bc[0] = st[j];
      st[j] = rotl64(t, rotc[i]);
      t = bc[0];
    }
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; i++) bc[i] = st[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    st[0] ^= KRC[round];
  }
}

static void keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
  u64 st[25];
  std::memset(st, 0, sizeof(st));
  const size_t rate = 136;
  uint8_t block[136];
  while (len >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      u64 w;
      std::memcpy(&w, data + i * 8, 8);
      st[i] ^= w;
    }
    keccak_f1600(st);
    data += rate;
    len -= rate;
  }
  std::memset(block, 0, rate);
  std::memcpy(block, data, len);
  block[len] = 0x01;
  block[rate - 1] |= 0x80;
  for (size_t i = 0; i < rate / 8; i++) {
    u64 w;
    std::memcpy(&w, block + i * 8, 8);
    st[i] ^= w;
  }
  keccak_f1600(st);
  std::memcpy(out, st, 32);
}

// ------------------------------------------------------------- 256-bit fe --
struct U256 {
  u64 d[4];  // little-endian limbs
};

static const U256 PRIME = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                            0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
static const U256 ORDER = {{0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                            0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL}};
// 2^256 - p
static const u64 P_C = 0x1000003D1ULL;
// 2^256 - n (129 bits: three limbs)
static const U256 N_C = {{0x402DA1732FC9BEBFULL, 0x4551231950B75FC4ULL, 1, 0}};

static inline bool is_zero(const U256& a) {
  return (a.d[0] | a.d[1] | a.d[2] | a.d[3]) == 0;
}

static inline int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.d[i] < b.d[i]) return -1;
    if (a.d[i] > b.d[i]) return 1;
  }
  return 0;
}

static inline u64 add_limbs(U256& r, const U256& a, const U256& b) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a.d[i] + b.d[i];
    r.d[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

static inline u64 sub_limbs(U256& r, const U256& a, const U256& b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.d[i] - b.d[i] - borrow;
    r.d[i] = (u64)t;
    borrow = (t >> 64) & 1;
  }
  return (u64)borrow;
}

static void load_be(U256& r, const uint8_t* b32) {
  for (int i = 0; i < 4; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | b32[(3 - i) * 8 + j];
    r.d[i] = w;
  }
}

static void store_be(uint8_t* b32, const U256& a) {
  for (int i = 0; i < 4; i++) {
    u64 w = a.d[3 - i];
    for (int j = 7; j >= 0; j--) {
      b32[i * 8 + j] = (uint8_t)w;
      w >>= 8;
    }
  }
}

// ---- arithmetic mod p ------------------------------------------------------

static inline void fe_norm(U256& a) {
  if (cmp(a, PRIME) >= 0) sub_limbs(a, a, PRIME);
}

static inline void fe_add(U256& r, const U256& a, const U256& b) {
  u64 carry = add_limbs(r, a, b);
  if (carry) {
    // r += 2^256 mod p == P_C
    u128 c = (u128)r.d[0] + P_C;
    r.d[0] = (u64)c;
    c >>= 64;
    for (int i = 1; i < 4 && c; i++) {
      c += r.d[i];
      r.d[i] = (u64)c;
      c >>= 64;
    }
  }
  fe_norm(r);
}

static inline void fe_sub(U256& r, const U256& a, const U256& b) {
  u64 borrow = sub_limbs(r, a, b);
  if (borrow) add_limbs(r, r, PRIME);
}

static void fe_mul(U256& r, const U256& a, const U256& b) {
  u64 w[8] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 t = (u128)a.d[i] * b.d[j] + w[i + j] + carry;
      w[i + j] = (u64)t;
      carry = t >> 64;
    }
    w[i + 4] = (u64)carry;
  }
  // fold: result = lo + hi * P_C  (hi*P_C fits 5 limbs)
  u64 hi[5];
  {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
      u128 t = (u128)w[4 + i] * P_C + carry;
      hi[i] = (u64)t;
      carry = t >> 64;
    }
    hi[4] = (u64)carry;
  }
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)w[i] + hi[i];
    r.d[i] = (u64)c;
    c >>= 64;
  }
  u64 over = (u64)c + hi[4];  // <= small
  while (over) {
    u128 t = (u128)r.d[0] + (u128)over * P_C;
    r.d[0] = (u64)t;
    u128 cc = t >> 64;
    over = 0;
    for (int i = 1; i < 4 && cc; i++) {
      cc += r.d[i];
      r.d[i] = (u64)cc;
      cc >>= 64;
    }
    over = (u64)cc;
  }
  fe_norm(r);
}

static inline void fe_sqr(U256& r, const U256& a) { fe_mul(r, a, a); }

static void fe_pow(U256& r, const U256& a, const U256& e) {
  U256 result = {{1, 0, 0, 0}};
  U256 base = a;
  for (int limb = 0; limb < 4; limb++) {
    u64 bits = e.d[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1) fe_mul(result, result, base);
      fe_sqr(base, base);
      bits >>= 1;
    }
  }
  r = result;
}

static void fe_inv(U256& r, const U256& a) {
  U256 e = PRIME;
  e.d[0] -= 2;  // p - 2 (no borrow: low limb is ...FC2F)
  fe_pow(r, a, e);
}

// y = sqrt(x) if it exists: x^((p+1)/4); caller verifies y^2 == x
static void fe_sqrt(U256& r, const U256& a) {
  // (p+1)/4 = 0x3FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFBFFFFF0C
  static const U256 E = {{0xFFFFFFFFBFFFFF0CULL, 0xFFFFFFFFFFFFFFFFULL,
                          0xFFFFFFFFFFFFFFFFULL, 0x3FFFFFFFFFFFFFFFULL}};
  fe_pow(r, a, E);
}

// ---- arithmetic mod n ------------------------------------------------------

static void sc_reduce_wide(U256& r, const u64 w_in[8]) {
  // iterated fold: x = lo + hi * N_C until hi == 0, then cond-subtract
  u64 w[8];
  std::memcpy(w, w_in, sizeof(w));
  // value shrinks by ~2^127 per fold; 6 passes provably reach hi == 0
  for (int pass = 0; pass < 6; pass++) {
    u64 hi[4] = {w[4], w[5], w[6], w[7]};
    if ((hi[0] | hi[1] | hi[2] | hi[3]) == 0) break;
    u64 prod[8] = {0};
    for (int i = 0; i < 4; i++) {
      u128 carry = 0;
      for (int j = 0; j < 3; j++) {  // N_C has 3 limbs
        u128 t = (u128)hi[i] * N_C.d[j] + prod[i + j] + carry;
        prod[i + j] = (u64)t;
        carry = t >> 64;
      }
      u128 t = (u128)prod[i + 3] + carry;
      prod[i + 3] = (u64)t;
      if (i + 4 < 8) prod[i + 4] += (u64)(t >> 64);
    }
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
      c += (u128)w[i] + prod[i];
      w[i] = (u64)c;
      c >>= 64;
    }
    for (int i = 4; i < 8; i++) {
      c += prod[i];
      w[i] = (u64)c;
      c >>= 64;
    }
  }
  r.d[0] = w[0]; r.d[1] = w[1]; r.d[2] = w[2]; r.d[3] = w[3];
  while (cmp(r, ORDER) >= 0) sub_limbs(r, r, ORDER);
}

static void sc_mul(U256& r, const U256& a, const U256& b) {
  u64 w[8] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 t = (u128)a.d[i] * b.d[j] + w[i + j] + carry;
      w[i + j] = (u64)t;
      carry = t >> 64;
    }
    w[i + 4] = (u64)carry;
  }
  sc_reduce_wide(r, w);
}

static void sc_pow(U256& r, const U256& a, const U256& e) {
  U256 result = {{1, 0, 0, 0}};
  U256 base = a;
  for (int limb = 0; limb < 4; limb++) {
    u64 bits = e.d[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1) sc_mul(result, result, base);
      sc_mul(base, base, base);
      bits >>= 1;
    }
  }
  r = result;
}

static void sc_inv(U256& r, const U256& a) {
  U256 e = ORDER;
  e.d[0] -= 2;
  sc_pow(r, a, e);
}

static void sc_sub(U256& r, const U256& a, const U256& b) {
  u64 borrow = sub_limbs(r, a, b);
  if (borrow) add_limbs(r, r, ORDER);
}

// ---- Jacobian point ops ----------------------------------------------------

struct Point {
  U256 x, y, z;  // z==0 => infinity
};

static const U256 FE_ONE = {{1, 0, 0, 0}};

static inline bool pt_is_inf(const Point& p) { return is_zero(p.z); }

static void pt_double(Point& r, const Point& p) {
  if (pt_is_inf(p)) { r = p; return; }
  // dbl-2009-l: A=X^2 B=Y^2 C=B^2 D=2((X+B)^2-A-C) E=3A F=E^2
  U256 A, B, C, D, E, F, t, t2;
  fe_sqr(A, p.x);
  fe_sqr(B, p.y);
  fe_sqr(C, B);
  fe_add(t, p.x, B);
  fe_sqr(t, t);
  fe_sub(t, t, A);
  fe_sub(t, t, C);
  fe_add(D, t, t);
  fe_add(E, A, A);
  fe_add(E, E, A);
  fe_sqr(F, E);
  // X3 = F - 2D
  fe_add(t, D, D);
  fe_sub(r.x, F, t);
  // Y3 = E*(D - X3) - 8C
  fe_sub(t, D, r.x);
  fe_mul(t, E, t);
  fe_add(t2, C, C);
  fe_add(t2, t2, t2);
  fe_add(t2, t2, t2);
  U256 y3;
  fe_sub(y3, t, t2);
  // Z3 = 2*Y1*Z1
  fe_mul(t, p.y, p.z);
  fe_add(r.z, t, t);
  r.y = y3;
}

static void pt_add(Point& r, const Point& p, const Point& q) {
  if (pt_is_inf(p)) { r = q; return; }
  if (pt_is_inf(q)) { r = p; return; }
  // add-2007-bl
  U256 Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, t;
  fe_sqr(Z1Z1, p.z);
  fe_sqr(Z2Z2, q.z);
  fe_mul(U1, p.x, Z2Z2);
  fe_mul(U2, q.x, Z1Z1);
  fe_mul(t, q.z, Z2Z2);
  fe_mul(S1, p.y, t);
  fe_mul(t, p.z, Z1Z1);
  fe_mul(S2, q.y, t);
  fe_sub(H, U2, U1);
  fe_sub(rr, S2, S1);
  if (is_zero(H)) {
    if (is_zero(rr)) { pt_double(r, p); return; }
    r.x = FE_ONE; r.y = FE_ONE;
    std::memset(r.z.d, 0, sizeof(r.z.d));  // infinity
    return;
  }
  fe_add(t, H, H);
  fe_sqr(I, t);
  fe_mul(J, H, I);
  fe_add(rr, rr, rr);
  fe_mul(V, U1, I);
  // X3 = r^2 - J - 2V
  fe_sqr(t, rr);
  fe_sub(t, t, J);
  fe_sub(t, t, V);
  fe_sub(r.x, t, V);
  // Y3 = r*(V - X3) - 2*S1*J
  fe_sub(t, V, r.x);
  fe_mul(t, rr, t);
  U256 t2;
  fe_mul(t2, S1, J);
  fe_add(t2, t2, t2);
  U256 y3;
  fe_sub(y3, t, t2);
  // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H
  fe_add(t, p.z, q.z);
  fe_sqr(t, t);
  fe_sub(t, t, Z1Z1);
  fe_sub(t, t, Z2Z2);
  fe_mul(r.z, t, H);
  r.y = y3;
}

// 4-bit windowed double-and-add (MSB first)
static void pt_mul(Point& r, const Point& p, const U256& k) {
  Point table[16];
  table[0].x = FE_ONE; table[0].y = FE_ONE;
  std::memset(table[0].z.d, 0, sizeof(table[0].z.d));
  table[1] = p;
  for (int i = 2; i < 16; i++) pt_add(table[i], table[i - 1], p);
  Point acc = table[0];
  bool started = false;
  for (int limb = 3; limb >= 0; limb--) {
    for (int shift = 60; shift >= 0; shift -= 4) {
      if (started)
        for (int d = 0; d < 4; d++) pt_double(acc, acc);
      int w = (int)((k.d[limb] >> shift) & 0xF);
      if (w) {
        pt_add(acc, acc, table[w]);
        started = true;
      } else if (!started) {
        continue;
      }
    }
  }
  r = acc;
}

static const Point G = {
    {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL, 0x55A06295CE870B07ULL,
      0x79BE667EF9DCBBACULL}},
    {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL, 0x5DA4FBFC0E1108A8ULL,
      0x483ADA7726A3C465ULL}},
    {{1, 0, 0, 0}}};

// ---- recovery --------------------------------------------------------------

// out_pub64: X||Y big-endian. Returns 1 ok / 0 invalid.
extern "C" int secp_pubkey_recover_one(const uint8_t* msg32,
                                       const uint8_t* sig64, int recid,
                                       uint8_t* out_pub64) {
  if (recid < 0 || recid > 3) return 0;
  U256 r, s;
  load_be(r, sig64);
  load_be(s, sig64 + 32);
  if (is_zero(r) || is_zero(s)) return 0;
  if (cmp(r, ORDER) >= 0 || cmp(s, ORDER) >= 0) return 0;

  // x = r + (recid>>1)*n must stay below p
  U256 x = r;
  if (recid & 2) {
    u64 carry = add_limbs(x, x, ORDER);
    if (carry || cmp(x, PRIME) >= 0) return 0;
  }
  // lift x
  U256 y2, y, chk;
  fe_sqr(y2, x);
  fe_mul(y2, y2, x);
  U256 seven = {{7, 0, 0, 0}};
  fe_add(y2, y2, seven);
  fe_sqrt(y, y2);
  fe_sqr(chk, y);
  if (cmp(chk, y2) != 0) return 0;
  if ((int)(y.d[0] & 1) != (recid & 1)) fe_sub(y, PRIME, y);

  Point R;
  R.x = x; R.y = y; R.z = FE_ONE;

  U256 e;
  load_be(e, msg32);
  while (cmp(e, ORDER) >= 0) sub_limbs(e, e, ORDER);

  // Q = r^-1 * (s*R - e*G)
  U256 rinv, u1, u2, zero = {{0, 0, 0, 0}};
  sc_inv(rinv, r);
  sc_mul(u2, s, rinv);              // u2 = s/r
  sc_sub(e, zero, e);               // e = -e
  sc_mul(u1, e, rinv);              // u1 = -e/r
  Point a, b, q;
  pt_mul(a, G, u1);
  pt_mul(b, R, u2);
  pt_add(q, a, b);
  if (pt_is_inf(q)) return 0;

  // to affine
  U256 zinv, zinv2, zinv3, qx, qy;
  fe_inv(zinv, q.z);
  fe_sqr(zinv2, zinv);
  fe_mul(zinv3, zinv2, zinv);
  fe_mul(qx, q.x, zinv2);
  fe_mul(qy, q.y, zinv3);
  store_be(out_pub64, qx);
  store_be(out_pub64 + 32, qy);
  return 1;
}

extern "C" void secp_recover_batch(const uint8_t* msgs32,
                                   const uint8_t* sigs64,
                                   const int32_t* recids, uint64_t n,
                                   int threads, uint8_t* out_addrs20,
                                   uint8_t* out_ok) {
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = hc ? (int)hc : 1;
  }
  if ((uint64_t)threads > n) threads = (int)(n ? n : 1);

  auto worker = [&](uint64_t start, uint64_t stride) {
    uint8_t pub[64], digest[32];
    for (uint64_t i = start; i < n; i += stride) {
      int ok = secp_pubkey_recover_one(msgs32 + 32 * i, sigs64 + 64 * i,
                                       recids[i], pub);
      out_ok[i] = (uint8_t)ok;
      if (ok) {
        keccak256(pub, 64, digest);
        std::memcpy(out_addrs20 + 20 * i, digest + 12, 20);
      } else {
        std::memset(out_addrs20 + 20 * i, 0, 20);
      }
    }
  };
  if (threads <= 1) {
    worker(0, 1);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; t++) pool.emplace_back(worker, t, threads);
  for (auto& th : pool) th.join();
}
