// Native MPT commit planner — the host half of the fused TPU commit.
//
// The round-1 profile showed the Python walk + RLP encode of the dirty set
// costing more than the entire CPU hash baseline (4.9s vs 4.2s for 275k
// nodes), capping the device path below 1x no matter how fast the kernel
// is. This planner rebuilds that host work natively: given the sorted
// (hashed-key, value) leaf set of a trie — the shape of every state-commit
// drain in the reference (core/state/statedb.go:952 IntermediateRoot,
// trie/trie.go:585 Commit) — it
//
//   1. constructs the Merkle-Patricia trie shape (hex-prefix semantics of
//      coreth trie/encoding.go, node model trie/node.go),
//   2. lays every hashed node's RLP (child-digest slots zeroed) directly
//      into the level-bucketed, keccak-padded segment layout that
//      ops/keccak_fused.fused_commit consumes on device, and
//   3. emits the patch tables (lane, byte-offset, child-row) that let the
//      device resolve the parent<-child digest dependency chain itself.
//
// The same plan can instead be executed on host (execute_cpu) with the
// threaded keccak — that is the bit-exactness oracle and the native CPU
// baseline. Exposed over a C ABI for ctypes (no pybind11 in this image).
//
// Build: native/mpt.py (g++ -O3 -march=native -shared -fPIC ... -lpthread)

#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <atomic>
#include <cstdlib>
#include <memory>
#include <vector>
#include <array>
#include <algorithm>

#include "mpt_common.h"
#include "mpt_pool.h"

namespace {

using mptc::kRate;
using mptc::keccak_padded;
using mptc::bytes_enc_len;
using mptc::list_hdr_len;
using mptc::write_bytes;
using mptc::write_list_hdr;
using mptc::compact_len;
using mptc::pow2_at_least;
using mptc::round_lanes;
using mptc::nibble;

// last-plan phase timings (seconds): [build, alloc, rows]; exported for
// perf triage (mpt_plan_last_timings; bench.py reports them)
thread_local double g_timings[3];

// single-slot buffer pool: repeated plans of similar size (the chain's
// per-block commits, bench repeats) reuse warm pages instead of paying
// kernel zero-fill + fault on every 100s-of-MB allocation
std::mutex g_pool_mu;
uint8_t* g_pool_buf = nullptr;
int64_t g_pool_cap = 0;

// returns the buffer AND its true capacity (a pooled buffer's real
// allocation, or the fresh over-allocation) — the caller must hand the
// same cap back to pool_release, or the pool would overstate capacity
// and later hand out undersized buffers
uint8_t* pool_acquire(int64_t size, int64_t* cap_out) {
  {
    std::lock_guard<std::mutex> g(g_pool_mu);
    if (g_pool_buf && g_pool_cap >= size) {
      uint8_t* b = g_pool_buf;
      *cap_out = g_pool_cap;
      g_pool_buf = nullptr;
      return b;
    }
  }
  *cap_out = size + size / 4;
  return new uint8_t[(size_t)(size + size / 4)];
}

void pool_release(uint8_t* buf, int64_t cap) {
  if (!buf) return;
  std::lock_guard<std::mutex> g(g_pool_mu);
  if (!g_pool_buf || cap > g_pool_cap) {
    delete[] g_pool_buf;
    g_pool_buf = buf;
    g_pool_cap = cap;
  } else {
    delete[] buf;
  }
}

inline double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Trie shape
// ---------------------------------------------------------------------------

// longest common nibble prefix of two 32-byte keys, starting at nibble
// `from`: byte-wise scan (2 nibbles per compare) with odd-edge fixups
inline int lcp_nibbles(const uint8_t* a, const uint8_t* b, int from) {
  int i = from;
  if (i & 1) {
    if (nibble(a, i) != nibble(b, i)) return i;
    ++i;
  }
  int byte = i >> 1;
  while (byte < 32 && a[byte] == b[byte]) ++byte;
  i = byte * 2;
  if (i >= 64) return 64;
  if (nibble(a, i) == nibble(b, i)) ++i;
  return i;
}

struct Node {
  // kind: 0 leaf, 1 extension, 2 branch
  uint8_t kind;
  uint8_t height;      // levels above the deepest descendant (leaf = 0)
  int32_t depth;       // nibble depth of this node's start
  int32_t nib_end;     // for leaf/ext: key nibbles span [depth, nib_end)
  int64_t key_idx;     // leaf: index of its key/value; ext/branch: first key
  int32_t enc_len;     // full RLP encoding length
  int32_t lane;        // packed digest row if hashed, -1 if embedded
  int32_t child[16];   // branch children node ids (-1 empty); ext: child[0]
};

struct Plan {
  // inputs: BORROWED pointers when the caller guarantees lifetime
  // (mpt_plan_borrowed — the ctypes wrapper pins the numpy arrays on the
  // CommitPlan object), else copies owned by the vectors below. The
  // borrow path saves a ~100 MB memcpy per 1M-leaf plan.
  const uint8_t* keys_p = nullptr;
  const uint8_t* vals_p = nullptr;
  const uint64_t* val_off_p = nullptr;
  std::vector<uint8_t> keys;     // owned copy (legacy entry point)
  std::vector<uint8_t> vals;
  std::vector<uint64_t> val_off;
  int64_t n = 0;

  std::vector<Node> nodes;
  int32_t root_id = -1;

  // segment layout (fused_commit format)
  struct Seg {
    int32_t blocks, lanes, gstart, n_patches;
    int64_t byte_base;            // offset of this segment in flat_msgs
    std::vector<int32_t> node_of_lane; // real lanes -> node id
    std::vector<int32_t> pl, po, pc;   // patch tables (lane, off, child row)
  };
  std::vector<Seg> segs;
  // flat: UNINITIALIZED pool buffer — rows are fully written by the
  // writer (incl. padding-tail + pad-lane memsets); returned to the pool
  // on destruction so repeated plans reuse warm pages
  uint8_t* flat = nullptr;
  int64_t flat_size = 0;
  int64_t flat_cap = 0;
  Plan() = default;
  Plan(const Plan&) = delete;             // manual buffer ownership:
  Plan& operator=(const Plan&) = delete;  // copies would double-release
  ~Plan() { pool_release(flat, flat_cap); }
  std::vector<int32_t> nblocks;  // per packed lane
  std::vector<int32_t> msg_len;  // real byte length per packed lane (pads: 0)
  int64_t total_lanes = 0;
  int64_t total_patches = 0;
  int64_t num_hashed = 0;
  int32_t root_pos = -1;
};


// hex-prefix compact encoding of key nibbles [from, to) with terminator flag
// (coreth trie/encoding.go hexToCompact semantics)

inline void write_compact(const uint8_t* key32, int from, int to, bool term,
                          uint8_t* out) {
  int nnib = to - from;
  bool odd = nnib & 1;
  out[0] = (uint8_t)(((term ? 2 : 0) | (odd ? 1 : 0)) << 4);
  int pos = 1, i = from;
  if (odd) {
    out[0] |= nibble(key32, i++);
  }
  for (; i < to; i += 2)
    out[pos++] = (uint8_t)((nibble(key32, i) << 4) | nibble(key32, i + 1));
}

// Build -------------------------------------------------------------------

struct Builder {
  const Plan& p;
  std::vector<Node>& nodes;  // output arena (Plan's, or a thread-local)

  // returns node id; fills enc_len/height
  int32_t build(int64_t lo, int64_t hi, int depth) {
    const uint8_t* k0 = p.keys_p + lo * 32;
    if (hi - lo == 1) {
      Node nd{};
      nd.kind = 0;
      nd.depth = depth;
      nd.nib_end = 64;
      nd.key_idx = lo;
      nd.height = 0;
      int vlen = (int)(p.val_off_p[lo + 1] - p.val_off_p[lo]);
      uint8_t tmp[34];
      int clen = compact_len(64 - depth);
      write_compact(k0, depth, 64, true, tmp);
      int key_enc = bytes_enc_len(tmp, clen);
      const uint8_t* v = p.vals_p + p.val_off_p[lo];
      int payload = key_enc + bytes_enc_len(v, vlen);
      nd.enc_len = list_hdr_len(payload) + payload;
      nodes.push_back(nd);
      return (int32_t)nodes.size() - 1;
    }
    // longest common prefix from depth between first and last key
    const uint8_t* kl = p.keys_p + (hi - 1) * 32;
    int lcp = lcp_nibbles(k0, kl, depth);
    if (lcp > depth) {
      int32_t child = build(lo, hi, lcp);
      Node nd{};
      nd.kind = 1;
      nd.depth = depth;
      nd.nib_end = lcp;
      nd.key_idx = lo;
      nd.child[0] = child;
      Node& c = nodes[child];
      nd.height = (uint8_t)(c.height + 1);
      uint8_t tmp[34];
      int clen = compact_len(lcp - depth);
      write_compact(k0, depth, lcp, false, tmp);
      int child_ref = c.enc_len < 32 ? c.enc_len : 33;
      int payload = bytes_enc_len(tmp, clen) + child_ref;
      nd.enc_len = list_hdr_len(payload) + payload;
      nodes.push_back(nd);
      return (int32_t)nodes.size() - 1;
    }
    // branch at `depth`
    Node nd{};
    nd.kind = 2;
    nd.depth = depth;
    nd.key_idx = lo;
    for (int i = 0; i < 16; ++i) nd.child[i] = -1;
    int payload = 1;  // empty 17th (value) slot: 0x80
    int hmax = -1;
    int64_t s = lo;
    while (s < hi) {
      int nb = nibble(p.keys_p + s * 32, depth);
      int64_t e = s + 1;
      while (e < hi && nibble(p.keys_p + e * 32, depth) == nb) ++e;
      int32_t child = build(s, e, depth + 1);
      nd.child[nb] = child;
      Node& c = nodes[child];
      payload += c.enc_len < 32 ? c.enc_len : 33;
      hmax = std::max(hmax, (int)c.height);
      s = e;
    }
    // empty child slots encode as 0x80 (1 byte each)
    int present = 0;
    for (int i = 0; i < 16; ++i)
      if (nd.child[i] >= 0) ++present;
    payload += 16 - present;
    nd.height = (uint8_t)(hmax + 1);
    nd.enc_len = list_hdr_len(payload) + payload;
    nodes.push_back(nd);
    return (int32_t)nodes.size() - 1;
  }
};

// Parallel tree build: the root's first-nibble subtrees are independent
// (sorted keys partition cleanly), so each builds into a thread-local
// arena; the merge appends arenas in nibble order with an O(n) child-index
// fixup and assembles the root branch. Falls back to the serial recursion
// when the root is not a branch (a shared first-nibble prefix — improbable
// for keccak-hashed keys) or the workload is small. Thread count:
// CORETH_TPU_PLAN_THREADS overrides hardware_concurrency (the sweep knob
// for PERF.md's scaling record).

int plan_threads() {
  const char* e = std::getenv("CORETH_TPU_PLAN_THREADS");
  if (e && *e) return std::max(1, std::atoi(e));
  return (int)std::max(1u, std::thread::hardware_concurrency());
}

// instrumentation for the thread-sweep record: parts built, threads used,
// slowest part (the wall-clock bound on real cores), total part CPU
thread_local double g_build_stats[4];

int32_t build_tree(Plan& p) {
  int threads = plan_threads();
  g_build_stats[0] = 0;
  g_build_stats[1] = 1;
  g_build_stats[2] = g_build_stats[3] = 0.0;
  const uint8_t* k0 = p.keys_p;
  const uint8_t* kl = p.keys_p + (p.n - 1) * 32;
  if (threads <= 1 || p.n < 4096 || lcp_nibbles(k0, kl, 0) > 0) {
    Builder b{p, p.nodes};
    return b.build(0, p.n, 0);
  }

  struct Part {
    int nb;
    int64_t lo, hi;
    std::vector<Node> nodes;
    int32_t local_root = -1;
    double wall = 0.0;
  };
  std::vector<Part> parts;
  int64_t s = 0;
  while (s < p.n) {
    int nb = nibble(p.keys_p + s * 32, 0);
    int64_t e = s + 1;
    while (e < p.n && nibble(p.keys_p + e * 32, 0) == nb) ++e;
    parts.push_back({nb, s, e});
    s = e;
  }

  int t = std::min<int>(threads, (int)parts.size());
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= parts.size()) return;
      Part& part = parts[i];
      double t0 = now_s();
      part.nodes.reserve((size_t)((part.hi - part.lo) * 15 / 10) + 16);
      Builder b{p, part.nodes};
      part.local_root = b.build(part.lo, part.hi, 1);
      part.wall = now_s() - t0;
    }
  };
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();

  // merge arenas in nibble order; child ids shift by each arena's base
  size_t total = 1;  // + root
  for (auto& part : parts) total += part.nodes.size();
  p.nodes.reserve(total);
  Node root{};
  root.kind = 2;
  root.depth = 0;
  root.key_idx = 0;
  for (int i = 0; i < 16; ++i) root.child[i] = -1;
  int payload = 1;
  int hmax = -1;
  for (auto& part : parts) {
    int32_t base = (int32_t)p.nodes.size();
    for (Node nd : part.nodes) {
      if (nd.kind == 1) {
        if (nd.child[0] >= 0) nd.child[0] += base;
      } else if (nd.kind == 2) {
        for (int i = 0; i < 16; ++i)
          if (nd.child[i] >= 0) nd.child[i] += base;
      }
      p.nodes.push_back(nd);
    }
    int32_t groot = part.local_root + base;
    root.child[part.nb] = groot;
    const Node& c = p.nodes[groot];
    payload += c.enc_len < 32 ? c.enc_len : 33;
    hmax = std::max(hmax, (int)c.height);
    g_build_stats[2] = std::max(g_build_stats[2], part.wall);
    g_build_stats[3] += part.wall;
  }
  payload += 16 - (int)parts.size();
  root.height = (uint8_t)(hmax + 1);
  root.enc_len = list_hdr_len(payload) + payload;
  p.nodes.push_back(root);
  g_build_stats[0] = (double)parts.size();
  g_build_stats[1] = (double)t;
  return (int32_t)p.nodes.size() - 1;
}

// Segment assignment: group hashed nodes by (height level, exact block
// count). Lane counts pad to a power of two up to 8192 and to multiples of
// 8192 above that — a bounded jit-shape set for small segments, <=4% pad
// waste for big ones (a pure pow2 policy wasted ~31% of the transfer on a
// 200k-lane leaf segment). A scratch lane absorbs patch-table pad writes.
struct SegKey {
  int level, blocks;
  bool operator<(const SegKey& o) const {
    return level != o.level ? level < o.level : blocks < o.blocks;
  }
};

// Write one node's RLP into `out`; children referenced by digest get a
// patch (offset within this lane row, child node id — remapped to packed
// row later); embedded children are written inline recursively.
struct Writer {
  Plan& p;
  std::vector<std::pair<int32_t, int32_t>>& patches;  // (off, child node id)
  uint8_t* base;

  void write_child_ref(int32_t cid, uint8_t*& out) {
    Node& c = p.nodes[cid];
    if (c.enc_len < 32) {
      write_node(cid, out);
    } else {
      *out++ = 0xA0;
      patches.emplace_back((int32_t)(out - base), cid);
      std::memset(out, 0, 32);
      out += 32;
    }
  }

  void write_node(int32_t id, uint8_t*& out) {
    Node& nd = p.nodes[id];
    if (nd.kind == 0) {
      uint8_t tmp[34];
      int clen = compact_len(64 - nd.depth);
      write_compact(p.keys_p + nd.key_idx * 32, nd.depth, 64, true, tmp);
      int vlen = (int)(p.val_off_p[nd.key_idx + 1] - p.val_off_p[nd.key_idx]);
      const uint8_t* v = p.vals_p + p.val_off_p[nd.key_idx];
      int payload = bytes_enc_len(tmp, clen) + bytes_enc_len(v, vlen);
      out = write_list_hdr(payload, out);
      out = write_bytes(tmp, clen, out);
      out = write_bytes(v, vlen, out);
    } else if (nd.kind == 1) {
      uint8_t tmp[34];
      int clen = compact_len(nd.nib_end - nd.depth);
      write_compact(p.keys_p + nd.key_idx * 32, nd.depth, nd.nib_end,
                    false, tmp);
      Node& c = p.nodes[nd.child[0]];
      int child_ref = c.enc_len < 32 ? c.enc_len : 33;
      int payload = bytes_enc_len(tmp, clen) + child_ref;
      out = write_list_hdr(payload, out);
      out = write_bytes(tmp, clen, out);
      write_child_ref(nd.child[0], out);
    } else {
      int payload = 1;
      for (int i = 0; i < 16; ++i) {
        if (nd.child[i] >= 0) {
          Node& c = p.nodes[nd.child[i]];
          payload += c.enc_len < 32 ? c.enc_len : 33;
        } else {
          payload += 1;
        }
      }
      out = write_list_hdr(payload, out);
      for (int i = 0; i < 16; ++i) {
        if (nd.child[i] >= 0)
          write_child_ref(nd.child[i], out);
        else
          *out++ = 0x80;
      }
      *out++ = 0x80;  // empty value slot (fixed-length keys: never occupied)
    }
  }
};

void layout(Plan& p) {
  // bucket hashed nodes by (level, blocks) — counting sort over the tiny
  // key space (height <= 64, blocks small) instead of a comparison sort
  // of ~1.4M entries (~100 ms at the 1M-leaf scale)
  std::vector<std::pair<SegKey, int32_t>> entries;
  entries.reserve(p.nodes.size());
  int max_h = 0, max_b = 1;
  for (int32_t id = 0; id < (int32_t)p.nodes.size(); ++id) {
    Node& nd = p.nodes[id];
    bool hashed = nd.enc_len >= 32 || id == p.root_id;
    nd.lane = -1;
    if (!hashed) continue;
    int blocks = nd.enc_len / kRate + 1;  // unbounded: giant values legal
    entries.push_back({{nd.height, blocks}, id});
    max_h = std::max(max_h, (int)nd.height);
    max_b = std::max(max_b, blocks);
  }
  const size_t key_space = (size_t)(max_h + 1) * (max_b + 1);
  if (key_space <= entries.size() / 4 + 1024) {
    // dense key space: O(n) counting sort (stable, same order as SegKey<)
    const int nb = max_b + 1;
    std::vector<int64_t> counts(key_space + 1, 0);
    for (auto& e : entries)
      ++counts[(size_t)e.first.level * nb + e.first.blocks + 1];
    for (size_t i = 1; i < counts.size(); ++i) counts[i] += counts[i - 1];
    std::vector<std::pair<SegKey, int32_t>> sorted(entries.size());
    for (auto& e : entries)
      sorted[counts[(size_t)e.first.level * nb + e.first.blocks]++] = e;
    entries.swap(sorted);
  } else {
    // sparse (e.g. one giant value -> huge max_b): a counting table would
    // dwarf the entry list; comparison sort is fine at these sizes
    std::stable_sort(entries.begin(), entries.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
  }
  p.num_hashed = (int64_t)entries.size();

  int64_t byte_base = 0;
  int32_t gstart = 0;
  size_t i = 0;
  while (i < entries.size()) {
    size_t j = i;
    while (j < entries.size() && !(entries[i].first < entries[j].first)) ++j;
    int count = (int)(j - i);
    Plan::Seg seg;
    seg.blocks = entries[i].first.blocks;
    // +1 scratch lane for patch-pad writes
    seg.lanes = round_lanes(count + 1);
    seg.gstart = gstart;
    seg.byte_base = byte_base;
    seg.node_of_lane.reserve(count);
    for (size_t k = i; k < j; ++k) {
      int32_t id = entries[k].second;
      p.nodes[id].lane = gstart + (int32_t)(k - i);
      seg.node_of_lane.push_back(id);
    }
    gstart += seg.lanes;
    byte_base += (int64_t)seg.lanes * seg.blocks * kRate;
    p.segs.push_back(std::move(seg));
    i = j;
  }
  p.total_lanes = gstart;
  double t0 = now_s();
  p.flat = pool_acquire(byte_base, &p.flat_cap);
  p.flat_size = byte_base;
  p.nblocks.assign(gstart, 1);
  p.msg_len.assign(gstart, 0);
  g_timings[1] = now_s() - t0;
  t0 = now_s();

  // write every hashed node's RLP into its padded row + collect patches;
  // rows are disjoint, so big segments fan out across hardware threads
  // (each thread keeps a local patch list, merged back in lane order so
  // the exported tables stay deterministic)
  p.total_patches = 0;
  int hw = plan_threads();
  for (auto& seg : p.segs) {
    int width = seg.blocks * kRate;
    seg.pl.clear();
    seg.po.clear();
    seg.pc.clear();
    int real = (int)seg.node_of_lane.size();

    auto write_range = [&](int from, int to,
                           std::vector<std::array<int32_t, 3>>& out_patches) {
      std::vector<std::pair<int32_t, int32_t>> patches;
      for (int lane = from; lane < to; ++lane) {
        int32_t id = seg.node_of_lane[lane];
        uint8_t* row = p.flat + seg.byte_base + (int64_t)lane * width;
        patches.clear();
        Writer w{p, patches, row};
        uint8_t* out = row;
        w.write_node(id, out);
        int len = (int)(out - row);
        // flat is uninitialized: zero the padding tail, then pad10*1
        std::memset(row + len, 0, width - len);
        row[len] ^= 0x01;
        row[width - 1] ^= 0x80;
        int32_t g = seg.gstart + lane;
        p.nblocks[g] = seg.blocks;
        p.msg_len[g] = len;
        for (auto& pr : patches)
          out_patches.push_back({lane, pr.first, p.nodes[pr.second].lane});
      }
    };

    if (hw > 1 && real >= 512) {
      // pooled fan-out (mpt_pool.h): parked workers make the per-level
      // dispatch a condvar wake, so levels far below the old 2048-lane
      // spawn threshold are now worth threading
      int t = std::min(hw, 16);
      std::vector<std::vector<std::array<int32_t, 3>>> locals(t);
      mptp::parallel(t, [&](int i, int nt) {
        int chunk = (real + nt - 1) / nt;
        write_range(i * chunk, std::min(real, (i + 1) * chunk),
                    locals[i]);
      });
      for (auto& lp : locals)
        for (auto& e : lp) {
          seg.pl.push_back(e[0]);
          seg.po.push_back(e[1]);
          seg.pc.push_back(e[2]);
        }
    } else {
      std::vector<std::array<int32_t, 3>> lp;
      write_range(0, real, lp);
      for (auto& e : lp) {
        seg.pl.push_back(e[0]);
        seg.po.push_back(e[1]);
        seg.pc.push_back(e[2]);
      }
    }
    // pad/scratch lanes were never written: zero them so the exported
    // buffer is deterministic and no heap bytes cross the FFI (<=4% of
    // the buffer; the big win — skipping the full-buffer zero — stands)
    if (seg.lanes > real)
      std::memset(p.flat + seg.byte_base + (int64_t)real * width, 0,
                  (int64_t)(seg.lanes - real) * width);
    // pad patch table to pow2 >= 16; writes land in the scratch lane
    int np = (int)seg.pl.size();
    seg.n_patches = np ? pow2_at_least(np, 16) : 0;
    int scratch = seg.lanes - 1;
    for (int k = np; k < seg.n_patches; ++k) {
      seg.pl.push_back(scratch);
      seg.po.push_back(0);
      seg.pc.push_back(0);
    }
    p.total_patches += seg.n_patches;
  }
  p.root_pos = p.nodes[p.root_id].lane;
  g_timings[2] = now_s() - t0;
}

}  // namespace

extern "C" {

static Plan* plan_core(Plan* p, uint64_t n) {
  p->n = (int64_t)n;
  p->nodes.reserve((size_t)(n * 15 / 10) + 16);
  double t0 = now_s();
  p->root_id = build_tree(*p);
  g_timings[0] = now_s() - t0;
  layout(*p);
  return p;
}

static bool keys_sorted(const uint8_t* keys, uint64_t n) {
  for (uint64_t i = 1; i < n; ++i)
    if (std::memcmp(keys + (i - 1) * 32, keys + i * 32, 32) >= 0) return false;
  return true;
}

void* mpt_plan(const uint8_t* keys, const uint8_t* vals,
               const uint64_t* val_off, uint64_t n) {
  if (n == 0) return nullptr;  // empty trie: caller returns EMPTY_ROOT
  // reject duplicate keys: the build recursion assumes strictly-sorted
  // distinct keys (a duplicate would read past nibble 64)
  if (!keys_sorted(keys, n)) return nullptr;
  Plan* p = new Plan();
  p->keys.assign(keys, keys + n * 32);
  p->vals.assign(vals, vals + val_off[n]);
  p->val_off.assign(val_off, val_off + n + 1);
  p->keys_p = p->keys.data();
  p->vals_p = p->vals.data();
  p->val_off_p = p->val_off.data();
  return plan_core(p, n);
}

// Zero-copy planning: the caller OWNS keys/vals/val_off and guarantees
// they outlive the plan (the ctypes wrapper pins the numpy arrays on the
// CommitPlan object). Saves the ~100 MB input memcpy at 1M leaves.
void* mpt_plan_borrowed(const uint8_t* keys, const uint8_t* vals,
                        const uint64_t* val_off, uint64_t n) {
  if (n == 0) return nullptr;
  if (!keys_sorted(keys, n)) return nullptr;
  Plan* p = new Plan();
  p->keys_p = keys;
  p->vals_p = vals;
  p->val_off_p = val_off;
  return plan_core(p, n);
}

// parallel-build stats of the LAST mpt_plan on this thread:
// [parts, threads_used, max_part_wall_s, sum_part_wall_s] — max_part is
// the wall-clock bound on a machine with >= threads real cores
void mpt_plan_build_stats(double* out4) {
  out4[0] = g_build_stats[0];
  out4[1] = g_build_stats[1];
  out4[2] = g_build_stats[2];
  out4[3] = g_build_stats[3];
}

// phase timings of the LAST mpt_plan on this thread: [build, alloc, rows]
void mpt_plan_last_timings(double* out3) {
  out3[0] = g_timings[0];
  out3[1] = g_timings[1];
  out3[2] = g_timings[2];
}

uint64_t mpt_plan_flat_bytes(void* h) { return ((Plan*)h)->flat_size; }
uint64_t mpt_plan_total_lanes(void* h) { return ((Plan*)h)->total_lanes; }
uint64_t mpt_plan_num_segments(void* h) { return ((Plan*)h)->segs.size(); }
uint64_t mpt_plan_total_patches(void* h) { return ((Plan*)h)->total_patches; }
uint64_t mpt_plan_num_hashed(void* h) { return ((Plan*)h)->num_hashed; }
uint64_t mpt_plan_num_nodes(void* h) { return ((Plan*)h)->nodes.size(); }
int32_t mpt_plan_root_pos(void* h) { return ((Plan*)h)->root_pos; }

// specs: int32[num_segments, 4] = (blocks, lanes, gstart, n_patches)
void mpt_plan_export(void* h, uint8_t* flat_msgs, int32_t* nblocks,
                     int32_t* patch_lane, int32_t* patch_off,
                     int32_t* patch_child, int32_t* specs) {
  Plan* p = (Plan*)h;
  std::memcpy(flat_msgs, p->flat, p->flat_size);
  std::memcpy(nblocks, p->nblocks.data(), p->nblocks.size() * 4);
  int64_t pp = 0;
  for (size_t s = 0; s < p->segs.size(); ++s) {
    auto& seg = p->segs[s];
    specs[4 * s + 0] = seg.blocks;
    specs[4 * s + 1] = seg.lanes;
    specs[4 * s + 2] = seg.gstart;
    specs[4 * s + 3] = seg.n_patches;
    std::memcpy(patch_lane + pp, seg.pl.data(), seg.pl.size() * 4);
    std::memcpy(patch_off + pp, seg.po.data(), seg.po.size() * 4);
    std::memcpy(patch_child + pp, seg.pc.data(), seg.pc.size() * 4);
    pp += seg.n_patches;
  }
}

// Execute the plan on host: per level-segment, patch child digests then
// hash lanes with `threads` workers. digests_out: uint8[total_lanes * 32].
// Returns the root digest in out_root32. This is the native CPU baseline
// and the oracle for device bit-exactness.
void mpt_plan_execute_cpu(void* h, int threads, uint8_t* digests_out,
                          uint8_t* out_root32) {
  Plan* p = (Plan*)h;
  std::vector<uint8_t> local;
  uint8_t* dig = digests_out;
  if (!dig) {
    local.assign((size_t)p->total_lanes * 32, 0);
    dig = local.data();
  }
  for (auto& seg : p->segs) {
    int width = seg.blocks * kRate;
    int real = (int)seg.node_of_lane.size();
    // patches reference earlier segments only — safe to apply before
    // hashing. They are UNDONE after the segment hashes (see below) so
    // the flat buffer keeps its zero digest slots: the device word path
    // (export_words + scatter-add) shares this buffer zero-copy and
    // requires pristine templates whatever order the caller runs in.
    for (size_t k = 0; k < seg.pl.size(); ++k) {
      if (seg.pl[k] >= real) continue;  // scratch-lane padding
      std::memcpy(p->flat + seg.byte_base +
                      (int64_t)seg.pl[k] * width + seg.po[k],
                  dig + (int64_t)seg.pc[k] * 32, 32);
    }
    auto hash_range = [&](int from, int to) {
      for (int lane = from; lane < to; ++lane) {
        keccak_padded(p->flat + seg.byte_base + (int64_t)lane * width,
                      seg.blocks, dig + ((int64_t)seg.gstart + lane) * 32);
      }
    };
    if (threads > 1 && real >= 64) {
      // pooled fan-out: the parked-worker dispatch (~us) makes small
      // levels worth threading (the old spawn-per-call floor was 256)
      mptp::parallel(threads, [&](int i, int nt) {
        int chunk = (real + nt - 1) / nt;
        hash_range(i * chunk, std::min(real, (i + 1) * chunk));
      });
    } else {
      hash_range(0, real);
    }
    // restore the zero digest slots (templates stay pristine)
    for (size_t k = 0; k < seg.pl.size(); ++k) {
      if (seg.pl[k] >= real) continue;
      std::memset(p->flat + seg.byte_base +
                      (int64_t)seg.pl[k] * width + seg.po[k],
                  0, 32);
    }
  }
  std::memcpy(out_root32, dig + (int64_t)p->root_pos * 32, 32);
}

// Zero-copy views for the u32 device path: the plan's flat buffer already
// IS the padded little-endian word stream keccak absorbs; exposing the
// pointer lets the host wrap it as an array and ship it straight to the
// device with no intermediate copy (the plan object owns the memory).
const uint8_t* mpt_plan_flat_ptr(void* h) { return ((Plan*)h)->flat; }

// specs only: int32[num_segments, 4] = (blocks, lanes, gstart, n_patches)
void mpt_plan_specs(void* h, int32_t* specs) {
  Plan* p = (Plan*)h;
  for (size_t s = 0; s < p->segs.size(); ++s) {
    specs[4 * s + 0] = p->segs[s].blocks;
    specs[4 * s + 1] = p->segs[s].lanes;
    specs[4 * s + 2] = p->segs[s].gstart;
    specs[4 * s + 3] = p->segs[s].n_patches;
  }
}

// Word-space patch export for the u32 device path (ops/keccak_planned.py):
// per patch the 32-byte child digest lands at byte offset B in the flat
// buffer; emitted as (dst_word = B/4, child_lane, shift = B%4). The device
// scatter-adds 9-word contribution strips built from gathered digest words
// — byte-level ops never reach the device. Pad entries (same per-segment
// pow2 padding as mpt_plan_export) carry child_lane = -1, which the
// executor maps to an all-zero sentinel digest row: their contribution is
// 0 and the scatter-add is a no-op wherever it lands.
void mpt_plan_export_word_patches(void* h, int32_t* dst_word,
                                  int32_t* child_lane, int32_t* shift) {
  Plan* p = (Plan*)h;
  int64_t pp = 0;
  for (auto& seg : p->segs) {
    int width = seg.blocks * kRate;
    int real = (int)seg.node_of_lane.size();
    for (size_t k = 0; k < seg.pl.size(); ++k, ++pp) {
      if (seg.pl[k] >= real) {  // scratch-lane pad entry
        dst_word[pp] = 0;
        child_lane[pp] = -1;
        shift[pp] = 0;
        continue;
      }
      int64_t byte_off = seg.byte_base + (int64_t)seg.pl[k] * width + seg.po[k];
      dst_word[pp] = (int32_t)(byte_off >> 2);
      child_lane[pp] = seg.pc[k];
      shift[pp] = (int32_t)(byte_off & 3);
    }
  }
}

// Per-lane real message lengths (for exporting node RLP to the store).
void mpt_plan_msg_lens(void* h, int32_t* out) {
  Plan* p = (Plan*)h;
  std::memcpy(out, p->msg_len.data(), p->msg_len.size() * 4);
}

void mpt_plan_free(void* h) { delete (Plan*)h; }

}  // extern "C"
