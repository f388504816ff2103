// Incremental native MPT — device-resident-commit planning across blocks.
//
// The full-rebuild planner (mpt.cpp) re-plans and re-ships the ENTIRE trie
// every commit: per-block cost is O(N) no matter how small the change.
// The reference never does that — trie/trie.go:573-626 re-hashes only the
// dirty subtree and trie/triedb/hashdb keeps the rest warm. This module is
// the TPU-native equivalent: a persistent pointer trie with a per-node
// digest cache, where each commit
//
//   1. applies the block's leaf updates (insert/replace/delete), marking
//      the touched root-paths dirty,
//   2. lays ONLY the dirty nodes into a keccak-padded, level-bucketed
//      mini-plan (same segment format ops/keccak_planned.py consumes):
//      clean hashed children are written as LITERAL digest bytes from the
//      cache (no patch, no transfer beyond the row itself); dirty children
//      get zeroed holes + on-device word patches exactly like mpt.cpp,
//   3. executes on host (the CPU-incremental baseline and oracle) or on
//      device (upload = O(dirty set), the PERF.md "real 8x+ unlock"),
//      then absorbs the dirty digests back into the cache.
//
// Node semantics mirror coreth_tpu/trie/trie.py (insert split/merge,
// delete collapse), which itself follows coreth trie/trie.go.
// Keys are fixed 64-nibble (keccak-hashed) paths — the only keyspace the
// state commit drain ever sees (core/state/statedb.go:952).
//
// Build: native/mpt.py (g++ -O3 -march=native -shared -fPIC ... -lpthread)

#include <cstdint>
#include <cstring>
#include <thread>
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

// ---- keccak-f[1600] (shared constants with mpt.cpp; the FIPS-202 spec) ----


// hex-prefix compact encoding of an unpacked nibble fragment

inline void write_compact_frag(const uint8_t* nib, int nnib, bool term,
                               uint8_t* out) {
  bool odd = nnib & 1;
  out[0] = (uint8_t)(((term ? 2 : 0) | (odd ? 1 : 0)) << 4);
  int pos = 1, i = 0;
  if (odd) out[0] |= nib[i++];
  for (; i < nnib; i += 2)
    out[pos++] = (uint8_t)((nib[i] << 4) | nib[i + 1]);
}

// ---- persistent trie ------------------------------------------------------

struct INode {
  uint8_t kind;     // 0 leaf, 1 ext, 2 branch
  bool dirty;
  // changed (re-hashed) since the last disk export: drives the O(delta)
  // interval flush (mpt_inc_export_delta_*) the resident chain adapter
  // uses in place of a full-image export — the analog of the reference's
  // dirty-forest Commit walking only nodes not yet on disk
  // (trie/triedb/hashdb database.go Commit)
  bool unexported;
  // resident mode: this node's device ROW bytes changed (not just a child
  // digest) — set by the updater on any mutation of the node's own
  // template (fragment/value/child-set/kind), by plan-time checks on
  // embedded or kind-unstable children, and on creation
  bool structural;
  uint8_t nnib;     // fragment length (leaf/ext)
  uint8_t row_blocks;  // block class of the resident device row (0: none)
  int32_t enc_len;  // cached RLP length (valid when !dirty or after plan)
  int32_t prev_enc;    // enc_len before this plan's recompute (res collect)
  int32_t lane;     // mini-plan lane (-1: embedded or clean)
  int32_t slot;     // persistent device digest-store slot (-1: none)
  int32_t row;      // persistent device arena row in class row_blocks
  uint8_t frag[64];
  uint8_t digest[32];
  std::vector<uint8_t> val;  // leaf payload
  INode* child[16];          // branch children; ext: child[0]

  INode(uint8_t k)
      : kind(k), dirty(true), unexported(true), structural(true), nnib(0),
        row_blocks(0),
        enc_len(-1), prev_enc(-1), lane(-1), slot(-1), row(-1) {
    std::memset(child, 0, sizeof(child));
  }
};

struct MiniSeg {
  int32_t blocks, lanes, gstart, n_patches;
  int64_t byte_base;
  std::vector<INode*> node_of_lane;
  std::vector<int32_t> pl, po, pc;  // patch (lane, byte off, child lane)
};

// Resident-plan segment: a (dirty-height level, block-count) bucket whose
// rows all live in the same device arena class.
struct ResSeg {
  int32_t blocks, lanes, gstart, n_patches, patch_off, lane_off;
  std::vector<INode*> node_of_lane;
  std::vector<uint8_t> fresh_of_lane;  // pass-1 upload decision per lane
};

constexpr int kMaxBlocks = 64;  // widest supported node row (8.7 KB RLP)
// Storage-lean wire format (SonicDB S6 shape): a fresh class-1 row whose
// RLP fits kLeanWidth bytes ships as a fixed-width content-only record —
// the device re-derives the keccak pad bits from the shipped length, so
// the wire carries 72 B of content + 4 B row index + 4 B length instead
// of the 136 B padded row. 72 covers every account/storage leaf shape
// (slim account RLP <= 70 B, storage slot leaf <= 69 B).
constexpr int kLeanWidth = 72;

struct Inc {
  INode* root = nullptr;
  int64_t n_leaves = 0;
  int64_t n_nodes = 0;

  // ---- resident-commit state (device-side store/arena bookkeeping) ----
  // slot 0 = zero sentinel ("no digest"), slot 1 = pad-lane scratch;
  // arena row 0 per class = scratch. Both are device-side conventions the
  // Python executor (ops/keccak_resident.py) mirrors.
  int32_t next_slot = 2;
  std::vector<int32_t> free_slots;
  struct ResCls {
    int32_t next_row = 1;
    std::vector<int32_t> free_rows;
    std::vector<uint8_t> fresh_rows;  // packed row bytes to upload
    std::vector<int32_t> fresh_idx;   // target arena rows
    // lean (content-only, kLeanWidth-byte) upload records, class 1 only:
    // the device zero-extends each record to a full padded row
    std::vector<uint8_t> lean_rows;
    std::vector<int32_t> lean_idx;
    std::vector<int32_t> lean_len;
  };
  std::vector<ResCls> rcls = std::vector<ResCls>(kMaxBlocks + 1);
  bool lean = false;  // lean wire format enabled (mpt_inc_set_lean)
  std::vector<ResSeg> rsegs;
  std::vector<int32_t> r_rowidx, r_lane_slot;
  // patch tables: byte offset in the arena (device derives word+shift),
  // signed source (+k: dig row k; -k: store slot k; 0: none), old slot
  std::vector<int32_t> r_off, r_src, r_oldidx;
  std::vector<INode*> r_embedded_dirty;
  int32_t r_root_lane = -1;
  int64_t r_total_lanes = 0, r_total_patches = 0, r_num_dirty = 0;
  int64_t r_fresh_bytes = 0;  // h2d row payload this commit (diagnostics)

  int32_t alloc_slot() {
    if (!free_slots.empty()) {
      int32_t s = free_slots.back();
      free_slots.pop_back();
      return s;
    }
    return next_slot++;
  }

  void release_device(INode* n) {
    if (n->slot >= 0) {
      free_slots.push_back(n->slot);
      n->slot = -1;
    }
    if (n->row >= 0) {
      rcls[n->row_blocks].free_rows.push_back(n->row);
      n->row = -1;
      n->row_blocks = 0;
    }
  }

  // delete one node, returning its device resources to the free lists
  void release(INode* n) {
    release_device(n);
    delete n;
  }

  // ---- undo journal (checkpoint/rollback) ----
  // One entry per applied update op: the key's PREVIOUS state. Rollback
  // replays entries in reverse through the normal updater, so the trie
  // (and its dirty/structural marks) land exactly where a fresh
  // application of the old values would — the chain adapter's
  // verify->reject/reorg enabler (core/blockchain.go:1424 reorg,
  // plugin/evm/block.go:173 Reject).
  struct Undo {
    std::vector<uint8_t> key;  // 32B
    std::vector<uint8_t> old_val;
    bool had_old;
  };
  std::vector<Undo> undo_log;
  std::vector<size_t> undo_marks;  // checkpoint stack: log sizes

  // active mini-plan. flat is allocated UNINITIALIZED — rows are fully
  // written (incl. a padding-tail memset); pad lanes hold garbage whose
  // digests nothing references
  std::vector<MiniSeg> segs;
  std::unique_ptr<uint8_t[]> flat;
  int64_t flat_size = 0;
  int64_t flat_cap = 0;
  std::vector<INode*> embedded_dirty;
  int64_t total_lanes = 0;
  int64_t total_patches = 0;
  int64_t num_dirty_hashed = 0;
  int32_t root_pos = -1;

  ~Inc() { free_node(root); }

  void free_node(INode* n) {
    if (!n) return;
    if (n->kind == 2) {
      for (auto* c : n->child) free_node(c);
    } else if (n->kind == 1) {
      free_node(n->child[0]);
    }
    delete n;
  }
};

// ---- bulk build from sorted leaves (initial state) ------------------------

INode* build_range(Inc& t, const uint8_t* keys, const uint8_t* vals,
                   const uint64_t* off, int64_t lo, int64_t hi, int depth) {
  ++t.n_nodes;
  const uint8_t* k0 = keys + lo * 32;
  if (hi - lo == 1) {
    INode* nd = new INode(0);
    nd->nnib = (uint8_t)(64 - depth);
    for (int i = depth; i < 64; ++i) nd->frag[i - depth] = nibble(k0, i);
    nd->val.assign(vals + off[lo], vals + off[lo + 1]);
    return nd;
  }
  const uint8_t* kl = keys + (hi - 1) * 32;
  int lcp = depth;
  while (lcp < 64 && nibble(k0, lcp) == nibble(kl, lcp)) ++lcp;
  if (lcp > depth) {
    INode* nd = new INode(1);
    nd->nnib = (uint8_t)(lcp - depth);
    for (int i = depth; i < lcp; ++i) nd->frag[i - depth] = nibble(k0, i);
    nd->child[0] = build_range(t, keys, vals, off, lo, hi, lcp);
    return nd;
  }
  INode* nd = new INode(2);
  int64_t s = lo;
  while (s < hi) {
    int nb = nibble(keys + s * 32, depth);
    int64_t e = s + 1;
    while (e < hi && nibble(keys + e * 32, depth) == nb) ++e;
    nd->child[nb] = build_range(t, keys, vals, off, s, e, depth + 1);
    s = e;
  }
  return nd;
}

// ---- incremental update (semantics of coreth_tpu/trie/trie.py) ------------

struct Updater {
  Inc& t;
  const uint8_t* key;  // 32 bytes, 64 nibbles
  std::vector<Inc::Undo>* journal = nullptr;  // open checkpoint scope

  // record the key's previous state exactly once per applied op, at the
  // mutation site (no separate pre-lookup): leaf replace/create/delete
  void record(const std::vector<uint8_t>* old_val) {
    if (!journal) return;
    Inc::Undo u;
    u.key.assign(key, key + 32);
    u.had_old = old_val != nullptr;
    if (old_val) u.old_val = *old_val;
    journal->push_back(std::move(u));
  }

  // insert/replace; returns (node, changed)
  INode* insert(INode* n, int pos, const uint8_t* v, int vlen, bool& changed) {
    if (!n) {
      record(nullptr);  // key was absent
      INode* nd = new INode(0);
      nd->nnib = (uint8_t)(64 - pos);
      for (int i = pos; i < 64; ++i) nd->frag[i - pos] = nibble(key, i);
      nd->val.assign(v, v + vlen);
      ++t.n_nodes;
      changed = true;
      return nd;
    }
    if (n->kind == 0 || n->kind == 1) {
      int match = 0;
      while (match < n->nnib && pos + match < 64 &&
             n->frag[match] == nibble(key, pos + match))
        ++match;
      if (match == n->nnib) {
        if (n->kind == 0) {
          // full key match (fixed-width keys): replace value
          if ((int)n->val.size() == vlen && !std::memcmp(n->val.data(), v, vlen)) {
            changed = false;
            return n;
          }
          record(&n->val);
          n->val.assign(v, v + vlen);
          n->dirty = true;
          n->structural = true;  // row bytes = value bytes
          changed = true;
          return n;
        }
        bool ch = false;
        INode* prev = n->child[0];
        n->child[0] = insert(n->child[0], pos + match, v, vlen, ch);
        if (n->child[0] != prev) n->structural = true;
        if (ch) n->dirty = true;
        changed = ch;
        return n;
      }
      // diverge inside the fragment: branch at the split nibble
      INode* branch = new INode(2);
      ++t.n_nodes;
      // old node keeps its tail after the split nibble
      int old_nib = n->frag[match];
      INode* old_tail;
      if (n->kind == 1 && match + 1 == n->nnib) {
        old_tail = n->child[0];  // ext fully consumed: child moves up CLEAN
        n->child[0] = nullptr;
        t.release(n);
        --t.n_nodes;
      } else {
        // shift fragment left; node keeps identity (and digest-dirtiness:
        // its ENCODING changes because the fragment shrank)
        std::memmove(n->frag, n->frag + match + 1, n->nnib - match - 1);
        n->nnib = (uint8_t)(n->nnib - match - 1);
        n->dirty = true;
        n->structural = true;
        old_tail = n;
      }
      branch->child[old_nib] = old_tail;
      bool ch = false;
      branch->child[nibble(key, pos + match)] =
          insert(nullptr, pos + match + 1, v, vlen, ch);
      INode* result = branch;
      if (match > 0) {
        INode* ext = new INode(1);
        ++t.n_nodes;
        ext->nnib = (uint8_t)match;
        for (int i = 0; i < match; ++i) ext->frag[i] = nibble(key, pos + i);
        ext->child[0] = branch;
        result = ext;
      }
      changed = true;
      return result;
    }
    // branch
    int nb = nibble(key, pos);
    bool ch = false;
    INode* prev = n->child[nb];
    n->child[nb] = insert(n->child[nb], pos + 1, v, vlen, ch);
    if (n->child[nb] != prev) n->structural = true;
    if (ch) n->dirty = true;
    changed = ch;
    return n;
  }

  // delete; returns (node or nullptr, changed)
  INode* erase(INode* n, int pos, bool& changed) {
    if (!n) {
      changed = false;
      return nullptr;
    }
    if (n->kind == 0) {
      for (int i = 0; i < n->nnib; ++i)
        if (n->frag[i] != nibble(key, pos + i)) {
          changed = false;
          return n;
        }
      record(&n->val);
      t.release(n);
      --t.n_nodes;
      changed = true;
      return nullptr;
    }
    if (n->kind == 1) {
      for (int i = 0; i < n->nnib; ++i)
        if (n->frag[i] != nibble(key, pos + i)) {
          changed = false;
          return n;
        }
      bool ch = false;
      INode* prev = n->child[0];
      INode* c = erase(n->child[0], pos + n->nnib, ch);
      if (!ch) {
        changed = false;
        return n;
      }
      n->child[0] = c;
      if (c != prev) n->structural = true;
      n->dirty = true;
      changed = true;
      if (c && (c->kind == 0 || c->kind == 1)) {
        // merge short nodes: ext+leaf -> leaf, ext+ext -> ext
        std::memcpy(n->frag + n->nnib, c->frag, c->nnib);
        n->nnib = (uint8_t)(n->nnib + c->nnib);
        n->kind = c->kind;
        n->val = std::move(c->val);
        n->child[0] = c->child[0];
        n->structural = true;
        c->child[0] = nullptr;
        t.release(c);
        --t.n_nodes;
      }
      return n;  // c == nullptr cannot happen: branch delete collapses first
    }
    // branch
    int nb = nibble(key, pos);
    bool ch = false;
    INode* prev = n->child[nb];
    n->child[nb] = erase(n->child[nb], pos + 1, ch);
    if (!ch) {
      changed = false;
      return n;
    }
    if (n->child[nb] != prev) n->structural = true;
    n->dirty = true;
    changed = true;
    int remain = -1, count = 0;
    for (int i = 0; i < 16; ++i)
      if (n->child[i]) {
        remain = i;
        ++count;
      }
    if (count >= 2) return n;
    // collapse: single remaining child merges with its slot nibble
    INode* c = n->child[remain];
    n->child[remain] = nullptr;
    t.release(n);
    --t.n_nodes;
    if (c->kind == 0 || c->kind == 1) {
      std::memmove(c->frag + 1, c->frag, c->nnib);
      c->frag[0] = (uint8_t)remain;
      c->nnib = (uint8_t)(c->nnib + 1);
      c->dirty = true;
      c->structural = true;
      return c;
    }
    INode* ext = new INode(1);
    ++t.n_nodes;
    ext->nnib = 1;
    ext->frag[0] = (uint8_t)remain;
    ext->child[0] = c;
    return ext;
  }
};

// ---- mini-plan over the dirty subtree -------------------------------------

inline int child_ref_len(const INode* c) {
  return c->enc_len < 32 ? c->enc_len : 33;
}

// RLP length of the compact fragment blob: 1..33 bytes, always < 56, and a
// single compact byte is < 0x80 (flags live in the top nibble: leaf-term
// 0x20/0x3x, ext 0x00/0x1x) so it self-encodes
inline int frag_enc_len(int clen) { return clen == 1 ? 1 : 1 + clen; }

// post-order: recompute enc_len of dirty nodes, collect by dirty-height.
// Shared by the mini-plan and the resident plan: it also saves prev_enc
// and lifts embedded/ref-unstable dirty children into parent->structural
// (both no-ops for the non-resident path, which ignores those fields).
int collect(INode* n, std::vector<std::vector<INode*>>& levels) {
  if (!n || !n->dirty) return -1;
  n->prev_enc = n->enc_len;
  // a dirty child forces a resident-parent re-upload when its reference
  // kind or inline bytes changed: embedded now, embedded before (incl.
  // brand-new nodes, prev_enc == -1), or never device-hashed
  auto unstable = [](const INode* c) {
    return c->enc_len < 32 || c->prev_enc < 32 || c->slot < 0;
  };
  int h = -1;
  if (n->kind == 0) {
    int payload = frag_enc_len(compact_len(n->nnib)) +
                  bytes_enc_len(n->val.data(), (int)n->val.size());
    n->enc_len = list_hdr_len(payload) + payload;
  } else if (n->kind == 1) {
    h = std::max(h, collect(n->child[0], levels));
    if (n->child[0]->dirty && unstable(n->child[0])) n->structural = true;
    int payload = frag_enc_len(compact_len(n->nnib)) +
                  child_ref_len(n->child[0]);
    n->enc_len = list_hdr_len(payload) + payload;
  } else {
    int payload = 1;
    for (int i = 0; i < 16; ++i) {
      if (n->child[i]) {
        h = std::max(h, collect(n->child[i], levels));
        if (n->child[i]->dirty && unstable(n->child[i])) n->structural = true;
        payload += child_ref_len(n->child[i]);
      } else {
        payload += 1;
      }
    }
    n->enc_len = list_hdr_len(payload) + payload;
  }
  ++h;
  if ((size_t)h >= levels.size()) levels.resize(h + 1);
  levels[h].push_back(n);
  return h;
}

// One row renderer for both planners; the policy decides how a HASHED
// child reference's 32 bytes land (literal cached digest vs zero hole)
// and records the patch. Embedded children always inline their bytes.
template <class Policy>
struct RowWriter {
  Policy policy;
  uint8_t* base;

  void write_child_ref(INode* c, uint8_t*& out) {
    if (c->enc_len < 32) {
      write_node(c, out);  // embedded (dirty or clean): inline bytes
    } else {
      *out++ = 0xA0;
      policy.hashed_child(c, (int32_t)(out - base), out);
      out += 32;
    }
  }

  void write_node(INode* n, uint8_t*& out) {
    uint8_t tmp[34];
    if (n->kind == 0) {
      int clen = compact_len(n->nnib);
      write_compact_frag(n->frag, n->nnib, true, tmp);
      int payload = bytes_enc_len(tmp, clen) +
                    bytes_enc_len(n->val.data(), (int)n->val.size());
      out = write_list_hdr(payload, out);
      out = write_bytes(tmp, clen, out);
      out = write_bytes(n->val.data(), (int)n->val.size(), out);
    } else if (n->kind == 1) {
      int clen = compact_len(n->nnib);
      write_compact_frag(n->frag, n->nnib, false, tmp);
      int payload = bytes_enc_len(tmp, clen) + child_ref_len(n->child[0]);
      out = write_list_hdr(payload, out);
      out = write_bytes(tmp, clen, out);
      write_child_ref(n->child[0], out);
    } else {
      int payload = 1;
      for (int i = 0; i < 16; ++i)
        payload += n->child[i] ? child_ref_len(n->child[i]) : 1;
      out = write_list_hdr(payload, out);
      for (int i = 0; i < 16; ++i) {
        if (n->child[i])
          write_child_ref(n->child[i], out);
        else
          *out++ = 0x80;
      }
      *out++ = 0x80;  // value slot: fixed-width keys never occupy it
    }
  }
};

// mini-plan policy: clean hashed children are literal digests from the
// host cache — the whole point of host-cached incrementality; dirty ones
// are zero holes + patches
struct MiniPolicy {
  std::vector<std::pair<int32_t, INode*>>& patches;  // (byte off, dirty child)

  void hashed_child(INode* c, int32_t off, uint8_t* dst32) {
    if (c->dirty) {
      patches.emplace_back(off, c);
      std::memset(dst32, 0, 32);
    } else {
      std::memcpy(dst32, c->digest, 32);
    }
  }
};

void mark_embedded_dirty(INode* n, std::vector<INode*>& out) {
  // dirty nodes with enc_len < 32 never get lanes; track to clear flags
  if (!n || !n->dirty) return;
  if (n->enc_len < 32) out.push_back(n);
  if (n->kind == 1) mark_embedded_dirty(n->child[0], out);
  if (n->kind == 2)
    for (int i = 0; i < 16; ++i) mark_embedded_dirty(n->child[i], out);
}

void build_plan(Inc& t) {
  t.segs.clear();
  t.flat_size = 0;
  t.embedded_dirty.clear();
  t.total_lanes = t.total_patches = 0;
  t.num_dirty_hashed = 0;
  t.root_pos = -1;
  if (!t.root || !t.root->dirty) return;

  std::vector<std::vector<INode*>> levels;
  collect(t.root, levels);

  // bucket dirty hashed nodes by (level, blocks); the root is always hashed
  struct Key {
    int level, blocks;
  };
  std::vector<std::pair<Key, INode*>> entries;
  for (size_t h = 0; h < levels.size(); ++h)
    for (INode* n : levels[h]) {
      bool hashed = n->enc_len >= 32 || n == t.root;
      n->lane = -1;
      if (!hashed) continue;
      entries.push_back({{(int)h, n->enc_len / kRate + 1}, n});
    }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const auto& a, const auto& b) {
                     return a.first.level != b.first.level
                                ? a.first.level < b.first.level
                                : a.first.blocks < b.first.blocks;
                   });
  t.num_dirty_hashed = (int64_t)entries.size();

  int64_t byte_base = 0;
  int32_t gstart = 0;
  size_t i = 0;
  while (i < entries.size()) {
    size_t j = i;
    while (j < entries.size() && entries[j].first.level == entries[i].first.level &&
           entries[j].first.blocks == entries[i].first.blocks)
      ++j;
    int count = (int)(j - i);
    MiniSeg seg;
    seg.blocks = entries[i].first.blocks;
    seg.lanes = round_lanes(count + 1);  // +1 scratch lane for patch pads
    seg.gstart = gstart;
    seg.byte_base = byte_base;
    for (size_t k = i; k < j; ++k) {
      entries[k].second->lane = gstart + (int32_t)(k - i);
      seg.node_of_lane.push_back(entries[k].second);
    }
    gstart += seg.lanes;
    byte_base += (int64_t)seg.lanes * seg.blocks * kRate;
    t.segs.push_back(std::move(seg));
    i = j;
  }
  t.total_lanes = gstart;
  if (byte_base > t.flat_cap) {   // grow geometrically, reuse across commits
    t.flat.reset(new uint8_t[byte_base * 3 / 2]);
    t.flat_cap = byte_base * 3 / 2;
  }
  t.flat_size = byte_base;

  for (auto& seg : t.segs) {
    int width = seg.blocks * kRate;
    int real = (int)seg.node_of_lane.size();
    std::vector<std::pair<int32_t, INode*>> patches;
    for (int lane = 0; lane < real; ++lane) {
      INode* n = seg.node_of_lane[lane];
      uint8_t* row = t.flat.get() + seg.byte_base + (int64_t)lane * width;
      patches.clear();
      RowWriter<MiniPolicy> w{{patches}, row};
      uint8_t* out = row;
      w.write_node(n, out);
      int len = (int)(out - row);
      std::memset(row + len, 0, width - len);  // uninitialized tail
      row[len] ^= 0x01;
      row[width - 1] ^= 0x80;
      for (auto& pr : patches) {
        seg.pl.push_back(lane);
        seg.po.push_back(pr.first);
        seg.pc.push_back(pr.second->lane);  // dirty children: lane assigned
      }
    }
    // zero the never-written pad/scratch lanes (deterministic export,
    // no heap/stale-commit bytes across the FFI)
    if (seg.lanes > real)
      std::memset(t.flat.get() + seg.byte_base + (int64_t)real * width, 0,
                  (int64_t)(seg.lanes - real) * width);
    int np = (int)seg.pl.size();
    seg.n_patches = np ? pow2_at_least(np, 16) : 0;
    int scratch = seg.lanes - 1;
    for (int k = np; k < seg.n_patches; ++k) {
      seg.pl.push_back(scratch);
      seg.po.push_back(0);
      seg.pc.push_back(-2);  // pad marker; exported as child_lane -1
    }
    t.total_patches += seg.n_patches;
  }
  t.root_pos = t.root->lane;
  mark_embedded_dirty(t.root, t.embedded_dirty);
}

// ---- resident plan --------------------------------------------------------
//
// Device-resident commits (the deferred-absorb + template-residency design,
// PERF.md "what would close the rest" #1+#2): node rows persist in per-
// block-class device arenas, digests persist in a device store, and a
// commit uploads ONLY fresh/structurally-changed rows plus patch tables.
// Parent holes are DELTA-patched: new_strip - old_strip in wrapping u32
// arithmetic, where old is the child's previous digest (store[slot]) —
// exact because every hole word is a sum of byte-disjoint contributions.
// Digests never return to the host (the root is read on demand); the
// host plans structure only, so planning commit k+1 overlaps device
// execution of commit k. Mirrors the warm-trie semantics of
// coreth trie/trie.go:573-626 with the absorb step deferred
// into device memory.

// resident policy: zero hole + patch for EVERY hashed child (resident
// rows never carry literal digests — all digest flow is store/dig
// gathers on device)
struct ResPatch {
  int32_t off;  // byte offset of the 32-byte hole within the row
  INode* child;
};

struct ResPolicy {
  std::vector<ResPatch>& patches;

  void hashed_child(INode* c, int32_t off, uint8_t* dst32) {
    patches.push_back({off, c});
    std::memset(dst32, 0, 32);
  }
};

// free device resources of dirty nodes that fell below the hash threshold
// (hashed -> embedded transition) and collect every embedded-dirty node so
// mark_clean can clear its flags
void collect_embedded_res(Inc& t, INode* n) {
  if (!n || !n->dirty) return;
  if (n->enc_len < 32 && n->lane < 0) {
    t.release_device(n);
    t.r_embedded_dirty.push_back(n);
  }
  if (n->kind == 1) collect_embedded_res(t, n->child[0]);
  if (n->kind == 2)
    for (int i = 0; i < 16; ++i) collect_embedded_res(t, n->child[i]);
}

// 0 = ok; 1 = node RLP wider than kMaxBlocks; 2 = an arena class would
// exceed the int32 byte-offset range (>2GB — beyond what fits in HBM
// alongside the store and dig buffers anyway)
int build_plan_res(Inc& t) {
  t.rsegs.clear();
  for (auto& c : t.rcls) {
    c.fresh_rows.clear();
    c.fresh_idx.clear();
    c.lean_rows.clear();
    c.lean_idx.clear();
    c.lean_len.clear();
  }
  t.r_rowidx.clear();
  t.r_lane_slot.clear();
  t.r_off.clear();
  t.r_src.clear();
  t.r_oldidx.clear();
  t.r_embedded_dirty.clear();
  t.r_root_lane = -1;
  t.r_total_lanes = t.r_total_patches = t.r_num_dirty = 0;
  t.r_fresh_bytes = 0;
  if (!t.root || !t.root->dirty) return 0;

  std::vector<std::vector<INode*>> levels;
  collect(t.root, levels);

  struct Key {
    int level, blocks;
  };
  std::vector<std::pair<Key, INode*>> entries;
  for (size_t h = 0; h < levels.size(); ++h)
    for (INode* n : levels[h]) {
      bool hashed = n->enc_len >= 32 || n == t.root;
      n->lane = -1;
      if (!hashed) continue;
      int blocks = n->enc_len / kRate + 1;
      if (blocks > kMaxBlocks) return 1;  // >8.6KB node RLP unsupported
      entries.push_back({{(int)h, blocks}, n});
    }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const auto& a, const auto& b) {
                     return a.first.level != b.first.level
                                ? a.first.level < b.first.level
                                : a.first.blocks < b.first.blocks;
                   });
  t.r_num_dirty = (int64_t)entries.size();

  {
    int64_t extra[kMaxBlocks + 1] = {};
    for (auto& e : entries) ++extra[e.first.blocks];
    for (int b = 1; b <= kMaxBlocks; ++b) {
      int64_t worst_rows = (int64_t)t.rcls[b].next_row + extra[b];
      if (worst_rows * b * kRate > 0x7FFFFFFFLL) return 2;
    }
  }

  // pass 1: segments, lanes, slot/row allocation, fresh-row classification
  int32_t gstart = 0;
  size_t i = 0;
  while (i < entries.size()) {
    size_t j = i;
    while (j < entries.size() &&
           entries[j].first.level == entries[i].first.level &&
           entries[j].first.blocks == entries[i].first.blocks)
      ++j;
    int count = (int)(j - i);
    ResSeg seg;
    seg.blocks = entries[i].first.blocks;
    seg.lanes = round_lanes(count);
    seg.gstart = gstart;
    seg.lane_off = (int32_t)t.r_rowidx.size();
    for (size_t k = i; k < j; ++k) {
      INode* n = entries[k].second;
      n->lane = gstart + (int32_t)(k - i);
      seg.node_of_lane.push_back(n);
      if (n->slot < 0) n->slot = t.alloc_slot();
      bool upload = n->structural || n->row < 0 || n->row_blocks != seg.blocks;
      if (upload) {
        if (n->row >= 0 && n->row_blocks != seg.blocks) {
          t.rcls[n->row_blocks].free_rows.push_back(n->row);
          n->row = -1;
        }
        auto& cls = t.rcls[seg.blocks];
        if (n->row < 0) {
          if (!cls.free_rows.empty()) {
            n->row = cls.free_rows.back();
            cls.free_rows.pop_back();
          } else {
            n->row = cls.next_row++;
          }
          n->row_blocks = (uint8_t)seg.blocks;
        }
      }
      seg.fresh_of_lane.push_back(upload ? 1 : 0);
      t.r_rowidx.push_back(n->row);
      t.r_lane_slot.push_back(n->slot);
    }
    for (int k = count; k < seg.lanes; ++k) {  // pad lanes
      t.r_rowidx.push_back(0);    // arena scratch row
      t.r_lane_slot.push_back(1); // store scratch slot
    }
    gstart += seg.lanes;
    t.rsegs.push_back(std::move(seg));
    i = j;
  }
  t.r_total_lanes = gstart;
  t.r_root_lane = t.root->lane;

  // pass 2: render rows (fresh ones into the packed upload buffers,
  // patch-only ones into scratch for offsets) and emit delta patches
  thread_local std::vector<uint8_t> scratch;
  if ((int)scratch.size() < kMaxBlocks * kRate)
    scratch.resize(kMaxBlocks * kRate);
  std::vector<ResPatch> patches;
  for (auto& seg : t.rsegs) {
    int width = seg.blocks * kRate;
    seg.patch_off = (int32_t)t.r_off.size();
    int np = 0;
    for (size_t lane = 0; lane < seg.node_of_lane.size(); ++lane) {
      INode* n = seg.node_of_lane[lane];
      bool upload = seg.fresh_of_lane[lane] != 0;
      patches.clear();
      uint8_t* row;
      if (upload && t.lean && seg.blocks == 1) {
        // lean wire format: render into scratch, ship the content-only
        // record when it fits; the device re-derives both keccak pad
        // bits (0x01 at len, 0x80 at byte 135) while zero-extending
        auto& cls = t.rcls[seg.blocks];
        row = scratch.data();
        RowWriter<ResPolicy> w{{patches}, row};
        uint8_t* out = row;
        w.write_node(n, out);
        int len = (int)(out - row);
        if (len <= kLeanWidth) {
          size_t base = cls.lean_rows.size();
          cls.lean_rows.resize(base + kLeanWidth, 0);
          std::memcpy(cls.lean_rows.data() + base, row, len);
          cls.lean_idx.push_back(n->row);
          cls.lean_len.push_back(len);
          t.r_fresh_bytes += kLeanWidth;
        } else {  // class-1 but wider than the lean record: full row
          size_t base = cls.fresh_rows.size();
          cls.fresh_rows.resize(base + width);
          uint8_t* frow = cls.fresh_rows.data() + base;
          std::memcpy(frow, row, len);
          std::memset(frow + len, 0, width - len);
          frow[len] ^= 0x01;  // keccak pad
          frow[width - 1] ^= 0x80;
          cls.fresh_idx.push_back(n->row);
          t.r_fresh_bytes += width;
        }
      } else if (upload) {
        auto& cls = t.rcls[seg.blocks];
        size_t base = cls.fresh_rows.size();
        cls.fresh_rows.resize(base + width);
        row = cls.fresh_rows.data() + base;
        cls.fresh_idx.push_back(n->row);
        RowWriter<ResPolicy> w{{patches}, row};
        uint8_t* out = row;
        w.write_node(n, out);
        int len = (int)(out - row);
        std::memset(row + len, 0, width - len);
        row[len] ^= 0x01;  // keccak pad
        row[width - 1] ^= 0x80;
        t.r_fresh_bytes += width;
      } else {
        row = scratch.data();
        RowWriter<ResPolicy> w{{patches}, row};
        uint8_t* out = row;
        w.write_node(n, out);  // offsets only; bytes discarded
      }
      for (auto& pr : patches) {
        INode* c = pr.child;
        bool cdirty = c->dirty;  // dirty hashed child: digest from dig
        if (!upload && !cdirty) continue;  // resident hole already correct
        int64_t byte_off = (int64_t)n->row * width + pr.off;
        t.r_off.push_back((int32_t)byte_off);  // pre-checked < 2^31
        t.r_src.push_back(cdirty ? c->lane + 1 : -c->slot);
        // patch-only rows subtract the child's previous digest (the hole
        // currently holds it); fresh rows have zero holes, so old = 0
        t.r_oldidx.push_back(upload ? 0 : c->slot);
        ++np;
      }
    }
    seg.n_patches = np ? pow2_at_least(np, 16) : 0;
    for (int k = np; k < seg.n_patches; ++k) {  // zero-delta pad patches
      t.r_off.push_back(0);
      t.r_src.push_back(0);
      t.r_oldidx.push_back(0);
    }
    t.r_total_patches += seg.n_patches;
  }
  collect_embedded_res(t, t.root);
  return 0;
}

void res_mark_clean(Inc& t) {
  for (auto& seg : t.rsegs)
    for (INode* n : seg.node_of_lane) {
      n->dirty = false;
      n->unexported = true;
      n->structural = false;
      n->lane = -1;
    }
  for (INode* n : t.r_embedded_dirty) {
    n->dirty = false;
    n->unexported = true;
    n->structural = false;
  }
  t.r_embedded_dirty.clear();
}

// Template-residency absorb: the resident plan ran on device but the
// host cache still wants every digest (so root()/export_nodes work and
// a device-failure takeover needs no full rehash). dig is the device's
// per-lane digest matrix WITHOUT the zero-sentinel row, laid out in
// global lane order (seg.gstart + lane), exactly absorb_digests' shape
// for the planned path. Folds in res_mark_clean so callers do one or
// the other, never both.
void res_absorb_digests(Inc& t, const uint8_t* dig) {
  for (auto& seg : t.rsegs)
    for (size_t lane = 0; lane < seg.node_of_lane.size(); ++lane) {
      INode* n = seg.node_of_lane[lane];
      std::memcpy(n->digest, dig + ((int64_t)seg.gstart + lane) * 32, 32);
      n->dirty = false;
      n->unexported = true;
      n->structural = false;
      n->lane = -1;
    }
  for (INode* n : t.r_embedded_dirty) {
    n->dirty = false;
    n->unexported = true;
    n->structural = false;
  }
  t.r_embedded_dirty.clear();
}

// Resolve a global resident-plan lane to its node (nullptr for pad
// lanes). Segments are gstart-ordered, so a binary search keeps the
// per-shard absorb O(lanes log segs).
INode* res_node_at_lane(Inc& t, int32_t lane) {
  size_t lo = 0, hi = t.rsegs.size();
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    const ResSeg& seg = t.rsegs[mid];
    if (lane < seg.gstart) {
      hi = mid;
    } else if (lane >= seg.gstart + seg.lanes) {
      lo = mid + 1;
    } else {
      size_t local = (size_t)(lane - seg.gstart);
      return local < seg.node_of_lane.size() ? seg.node_of_lane[local]
                                             : nullptr;
    }
  }
  return nullptr;
}

void absorb_digests(Inc& t, const uint8_t* dig) {
  for (auto& seg : t.segs)
    for (size_t lane = 0; lane < seg.node_of_lane.size(); ++lane) {
      INode* n = seg.node_of_lane[lane];
      std::memcpy(n->digest, dig + ((int64_t)seg.gstart + lane) * 32, 32);
      n->dirty = false;
      n->unexported = true;
      n->lane = -1;
    }
  for (INode* n : t.embedded_dirty) {
    n->dirty = false;
    n->unexported = true;
  }
  t.embedded_dirty.clear();
}

// post-order walk over every node; F(INode*)
template <class F>
void walk_all(INode* n, F&& f) {
  if (!n) return;
  if (n->kind == 2) {
    for (auto* c : n->child) walk_all(c, f);
  } else if (n->kind == 1) {
    walk_all(n->child[0], f);
  }
  f(n);
}

// export policy: every hashed child reference is its literal cached digest
struct LiteralPolicy {
  void hashed_child(INode* c, int32_t, uint8_t* dst32) {
    std::memcpy(dst32, c->digest, 32);
  }
};

}  // namespace

extern "C" {

void* mpt_inc_new(const uint8_t* keys, const uint8_t* vals,
                  const uint64_t* val_off, uint64_t n) {
  for (uint64_t i = 1; i < n; ++i)
    if (std::memcmp(keys + (i - 1) * 32, keys + i * 32, 32) >= 0) return nullptr;
  Inc* t = new Inc();
  t->n_leaves = (int64_t)n;
  if (n > 0) t->root = build_range(*t, keys, vals, val_off, 0, (int64_t)n, 0);
  return t;
}

// Apply a batch of updates; vlen == 0 deletes the key. Keys need not be
// sorted. Returns the number of keys whose application changed the trie.
// With an open checkpoint, every APPLIED op journals the key's previous
// state for rollback.
uint64_t mpt_inc_update(void* h, const uint8_t* keys, const uint8_t* vals,
                        const uint64_t* val_off, uint64_t n) {
  Inc* t = (Inc*)h;
  uint64_t changed_n = 0;
  std::vector<Inc::Undo>* journal =
      t->undo_marks.empty() ? nullptr : &t->undo_log;
  for (uint64_t i = 0; i < n; ++i) {
    const uint8_t* key = keys + i * 32;
    Updater u{*t, key, journal};
    bool changed = false;
    int vlen = (int)(val_off[i + 1] - val_off[i]);
    if (vlen == 0) {
      t->root = u.erase(t->root, 0, changed);
    } else {
      t->root = u.insert(t->root, 0, vals + val_off[i], vlen, changed);
    }
    if (changed) ++changed_n;
  }
  return changed_n;
}

// ---- checkpoint / rollback ------------------------------------------------

void mpt_inc_checkpoint(void* h) {
  Inc* t = (Inc*)h;
  t->undo_marks.push_back(t->undo_log.size());
}

// Drop the most recent checkpoint, keeping its changes. Entries merge
// into the enclosing checkpoint if one remains (nested scopes).
void mpt_inc_discard_checkpoint(void* h) {
  Inc* t = (Inc*)h;
  if (t->undo_marks.empty()) return;
  t->undo_marks.pop_back();
  // with an enclosing scope, entries stay — they belong to it now
  if (t->undo_marks.empty()) t->undo_log.clear();
}

// Drop the OLDEST k checkpoints, keeping their changes and reclaiming
// their journal entries. The remaining scopes rebase onto the new log
// floor. This is the tip-buffer flush: finalized history deeper than
// the retained window stops being rewindable, so its undo memory frees
// (reference: the 32-root tip buffer of core/state_manager.go:189+
// bounds how far back recent-state reads reach).
void mpt_inc_flush_oldest(void* h, uint64_t k) {
  Inc* t = (Inc*)h;
  if (k == 0 || t->undo_marks.empty()) return;
  if (k >= t->undo_marks.size()) {
    t->undo_marks.clear();
    t->undo_log.clear();
    return;
  }
  size_t floor = t->undo_marks[k];
  t->undo_log.erase(t->undo_log.begin(), t->undo_log.begin() + floor);
  t->undo_marks.erase(t->undo_marks.begin(), t->undo_marks.begin() + k);
  for (size_t& m : t->undo_marks) m -= floor;
}

// Revert every update since the most recent checkpoint (reverse replay
// through the normal updater, so dirty/structural marks stay coherent
// for the next plan). Returns the number of ops reverted.
uint64_t mpt_inc_rollback(void* h) {
  Inc* t = (Inc*)h;
  if (t->undo_marks.empty()) return 0;
  size_t mark = t->undo_marks.back();
  t->undo_marks.pop_back();
  uint64_t reverted = 0;
  for (size_t i = t->undo_log.size(); i > mark; --i) {
    Inc::Undo& u = t->undo_log[i - 1];
    Updater up{*t, u.key.data()};  // journal deliberately nullptr
    bool changed = false;
    if (u.had_old) {
      t->root = up.insert(t->root, 0, u.old_val.data(),
                          (int)u.old_val.size(), changed);
    } else {
      t->root = up.erase(t->root, 0, changed);
    }
    ++reverted;
  }
  t->undo_log.resize(mark);
  return reverted;
}

// Build the dirty-subtree mini-plan; returns the number of segments.
uint64_t mpt_inc_plan(void* h) {
  Inc* t = (Inc*)h;
  build_plan(*t);
  return t->segs.size();
}

uint64_t mpt_inc_flat_bytes(void* h) { return ((Inc*)h)->flat_size; }

uint64_t mpt_inc_num_nodes(void* h) { return ((Inc*)h)->n_nodes; }
uint64_t mpt_inc_num_dirty(void* h) { return ((Inc*)h)->num_dirty_hashed; }
uint64_t mpt_inc_total_lanes(void* h) { return ((Inc*)h)->total_lanes; }
uint64_t mpt_inc_total_patches(void* h) { return ((Inc*)h)->total_patches; }
int32_t mpt_inc_root_pos(void* h) { return ((Inc*)h)->root_pos; }
const uint8_t* mpt_inc_flat_ptr(void* h) { return ((Inc*)h)->flat.get(); }

void mpt_inc_specs(void* h, int32_t* specs) {
  Inc* t = (Inc*)h;
  for (size_t s = 0; s < t->segs.size(); ++s) {
    specs[4 * s + 0] = t->segs[s].blocks;
    specs[4 * s + 1] = t->segs[s].lanes;
    specs[4 * s + 2] = t->segs[s].gstart;
    specs[4 * s + 3] = t->segs[s].n_patches;
  }
}

void mpt_inc_word_patches(void* h, int32_t* dst_word, int32_t* child_lane,
                          int32_t* shift) {
  Inc* t = (Inc*)h;
  int64_t pp = 0;
  for (auto& seg : t->segs) {
    int width = seg.blocks * kRate;
    for (size_t k = 0; k < seg.pl.size(); ++k, ++pp) {
      if (seg.pc[k] == -2) {  // pad entry
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

// Host execution of the mini-plan + digest absorption: the CPU-incremental
// baseline (what the reference's dirty-walk costs natively) and the oracle.
void mpt_inc_execute_cpu(void* h, int threads, uint8_t* out_root32) {
  Inc* t = (Inc*)h;
  std::vector<uint8_t> dig((size_t)t->total_lanes * 32, 0);
  for (auto& seg : t->segs) {
    int width = seg.blocks * kRate;
    int real = (int)seg.node_of_lane.size();
    for (size_t k = 0; k < seg.pl.size(); ++k) {
      if (seg.pc[k] == -2) continue;
      std::memcpy(t->flat.get() + seg.byte_base +
                      (int64_t)seg.pl[k] * width + seg.po[k],
                  dig.data() + (int64_t)seg.pc[k] * 32, 32);
    }
    auto hash_range = [&](int from, int to) {
      for (int lane = from; lane < to; ++lane)
        keccak_padded(t->flat.get() + seg.byte_base + (int64_t)lane * width,
                      seg.blocks, dig.data() + ((int64_t)seg.gstart + lane) * 32);
    };
    if (threads > 1 && real >= 64) {
      // pooled level fan-out (mpt_pool.h): the resident mini-plan's
      // segments ARE dirty-height levels, so this is the reference's
      // 16-goroutine per-level hash (trie/hasher.go:124-139) with
      // parked workers instead of per-level thread spawns
      mptp::parallel(threads, [&](int i, int nt) {
        int chunk = (real + nt - 1) / nt;
        hash_range(i * chunk, std::min(real, (i + 1) * chunk));
      });
    } else {
      hash_range(0, real);
    }
    // restore pristine zero holes so the device leg can reuse the buffer
    for (size_t k = 0; k < seg.pl.size(); ++k) {
      if (seg.pc[k] == -2) continue;
      std::memset(t->flat.get() + seg.byte_base +
                      (int64_t)seg.pl[k] * width + seg.po[k],
                  0, 32);
    }
  }
  if (t->root_pos >= 0)
    std::memcpy(out_root32, dig.data() + (int64_t)t->root_pos * 32, 32);
  absorb_digests(*t, dig.data());
}

// Absorb device-computed digests (uint8[total_lanes * 32], lane order).
void mpt_inc_absorb(void* h, const uint8_t* dig, uint8_t* out_root32) {
  Inc* t = (Inc*)h;
  if (t->root_pos >= 0)
    std::memcpy(out_root32, dig + (int64_t)t->root_pos * 32, 32);
  absorb_digests(*t, dig);
}

// ---- resident-plan ABI ----------------------------------------------------

// Build the resident plan. Returns the segment count, or UINT64_MAX on
// failure (a node wider than kMaxBlocks rate blocks).
uint64_t mpt_inc_plan_res(void* h) {
  Inc* t = (Inc*)h;
  int err = build_plan_res(*t);
  if (err == 1) return (uint64_t)-1;  // node too wide
  if (err == 2) return (uint64_t)-2;  // arena byte-offset range
  return t->rsegs.size();
}

// out[7]: total_lanes, total_patches, store_slots_needed (next_slot),
// root_lane, num_dirty_hashed, fresh_row_bytes, n_classes (kMaxBlocks+1)
void mpt_inc_res_meta(void* h, int64_t* out) {
  Inc* t = (Inc*)h;
  out[0] = t->r_total_lanes;
  out[1] = t->r_total_patches;
  out[2] = t->next_slot;
  out[3] = t->r_root_lane;
  out[4] = t->r_num_dirty;
  out[5] = t->r_fresh_bytes;
  out[6] = kMaxBlocks + 1;
}

// per segment, 6 ints: blocks, lanes, gstart, n_patches, patch_off, lane_off
void mpt_inc_res_specs(void* h, int32_t* out) {
  Inc* t = (Inc*)h;
  for (size_t s = 0; s < t->rsegs.size(); ++s) {
    const ResSeg& g = t->rsegs[s];
    out[6 * s + 0] = g.blocks;
    out[6 * s + 1] = g.lanes;
    out[6 * s + 2] = g.gstart;
    out[6 * s + 3] = g.n_patches;
    out[6 * s + 4] = g.patch_off;
    out[6 * s + 5] = g.lane_off;
  }
}

// per class, 2 ints: fresh row count, arena rows needed (next_row)
void mpt_inc_res_cls_counts(void* h, int32_t* out) {
  Inc* t = (Inc*)h;
  for (int c = 0; c <= kMaxBlocks; ++c) {
    out[2 * c + 0] = (int32_t)(t->rcls[c].fresh_idx.size());
    out[2 * c + 1] = t->rcls[c].next_row;
  }
}

void mpt_inc_res_fresh(void* h, int32_t cls, uint8_t* rows, int32_t* idx) {
  Inc* t = (Inc*)h;
  auto& c = t->rcls[cls];
  if (!c.fresh_rows.empty())
    std::memcpy(rows, c.fresh_rows.data(), c.fresh_rows.size());
  if (!c.fresh_idx.empty())
    std::memcpy(idx, c.fresh_idx.data(), c.fresh_idx.size() * 4);
}

// Lean wire format (storage-lean node rows). Enabled per trie BEFORE
// the first resident plan; flipping it mid-residency is safe (it only
// changes how FRESH class-1 rows travel, never what the arena holds).
void mpt_inc_set_lean(void* h, int32_t on) { ((Inc*)h)->lean = on != 0; }

// Lean class-1 records of the current plan: count, then the packed
// kLeanWidth-byte content records with their arena rows and RLP
// lengths (the device derives keccak padding from the length).
int64_t mpt_inc_res_lean_count(void* h) {
  return (int64_t)((Inc*)h)->rcls[1].lean_idx.size();
}

void mpt_inc_res_lean(void* h, uint8_t* rows, int32_t* idx, int32_t* lens) {
  Inc* t = (Inc*)h;
  auto& c = t->rcls[1];
  if (!c.lean_rows.empty())
    std::memcpy(rows, c.lean_rows.data(), c.lean_rows.size());
  if (!c.lean_idx.empty()) {
    std::memcpy(idx, c.lean_idx.data(), c.lean_idx.size() * 4);
    std::memcpy(lens, c.lean_len.data(), c.lean_len.size() * 4);
  }
}

void mpt_inc_res_tables(void* h, int32_t* rowidx, int32_t* lane_slot,
                        int32_t* off, int32_t* src, int32_t* oldidx) {
  Inc* t = (Inc*)h;
  auto cp = [](const std::vector<int32_t>& v, int32_t* out) {
    if (!v.empty()) std::memcpy(out, v.data(), v.size() * 4);
  };
  cp(t->r_rowidx, rowidx);
  cp(t->r_lane_slot, lane_slot);
  cp(t->r_off, off);
  cp(t->r_src, src);
  cp(t->r_oldidx, oldidx);
}

// After the device program is dispatched: clear dirty/structural flags.
// Digests deliberately do NOT return to the host (deferred absorb).
void mpt_inc_res_mark_clean(void* h) { res_mark_clean(*(Inc*)h); }

// Template-residency variant: the resident plan's digest matrix came
// back (uint8[total_lanes * 32], global lane order, sentinel row already
// stripped) — absorb it into the host cache AND clear the dirty flags.
// out_root32 gets the root digest when the root was among this commit's
// lanes (r_root_lane >= 0), else stays untouched.
void mpt_inc_res_absorb(void* h, const uint8_t* dig, uint8_t* out_root32) {
  Inc* t = (Inc*)h;
  if (t->r_root_lane >= 0)
    std::memcpy(out_root32, dig + (int64_t)t->r_root_lane * 32, 32);
  res_absorb_digests(*t, dig);
}

// Per-shard template absorb (mesh commits): absorb n digests addressed
// by GLOBAL lane index — dig[i] belongs to lanes[i] — so each mesh
// shard's digest partition lands in the host cache straight from that
// shard's store readback, with no replicated-dig all-gather. Pad lanes
// and lanes already absorbed this commit (lane reset to -1) are
// skipped. Unlike mpt_inc_res_absorb this does NOT fold the
// mark-clean: flags stay set until mpt_inc_res_absorb_finish confirms
// every lane arrived. Returns the number of digests absorbed.
int64_t mpt_inc_res_absorb_lanes(void* h, const int32_t* lanes,
                                 const uint8_t* dig, int64_t n) {
  Inc* t = (Inc*)h;
  int64_t absorbed = 0;
  for (int64_t i = 0; i < n; ++i) {
    INode* node = res_node_at_lane(*t, lanes[i]);
    if (!node || node->lane != lanes[i]) continue;
    std::memcpy(node->digest, dig + i * 32, 32);
    node->dirty = false;
    node->unexported = true;
    node->structural = false;
    node->lane = -1;
    ++absorbed;
  }
  return absorbed;
}

// Close a per-shard absorb: returns the number of plan lanes whose
// digest never arrived (those nodes stay dirty, so the next plan
// re-hashes them — a partial absorb can never serve a stale cache).
// Only on a COMPLETE absorb (return 0) are the embedded-dirty flags
// cleared and the root digest written to out_root32 (when the root was
// among this plan's lanes) — the same contract mpt_inc_res_absorb
// fulfils in one shot for the full-readback path.
int64_t mpt_inc_res_absorb_finish(void* h, uint8_t* out_root32) {
  Inc* t = (Inc*)h;
  int64_t missed = 0;
  for (auto& seg : t->rsegs)
    for (INode* n : seg.node_of_lane)
      if (n->lane >= 0) ++missed;
  if (missed) return missed;
  for (INode* n : t->r_embedded_dirty) {
    n->dirty = false;
    n->unexported = true;
    n->structural = false;
  }
  t->r_embedded_dirty.clear();
  if (t->r_root_lane >= 0 && t->root)
    std::memcpy(out_root32, t->root->digest, 32);
  return 0;
}

// Mesh-ladder demotion seam: abandon EVERY device-side assignment (store
// slots, arena rows, both free lists) and mark the whole trie dirty, so
// the next resident plan classifies EVERY row as fresh and re-uploads it
// — exactly the first commit after construction — onto a brand-new
// executor. Nothing from the old executor's store ever enters a delta
// patch again (fresh rows start with zeroed holes and old = the zero
// sentinel), which is what makes the mesh -> single-device rebuild of
// trie/resident_mirror.py bit-exact. The undo journal stores VALUES and
// rollback replays them through the normal updater, so no rolled-back
// node can resurface with a stale pre-reset row/slot.
void mpt_inc_res_reset(void* h) {
  Inc* t = (Inc*)h;
  walk_all(t->root, [](INode* n) {
    n->dirty = true;
    n->structural = true;
    n->enc_len = -1;
    n->lane = -1;
    n->slot = -1;
    n->row = -1;
    n->row_blocks = 0;
  });
  t->next_slot = 2;
  t->free_slots.clear();
  for (auto& c : t->rcls) {
    c.next_row = 1;
    c.free_rows.clear();
    c.fresh_rows.clear();
    c.fresh_idx.clear();
    c.lean_rows.clear();
    c.lean_idx.clear();
    c.lean_len.clear();
  }
}

// Device-failure takeover seam: mark EVERY node dirty so the next host
// plan re-hashes the whole trie. After a resident (device-store) commit
// history the host digest cache is stale; a full host rehash
// (mark_all_dirty + plan + execute_cpu) re-establishes it so the trie
// can continue in host commit mode with the device gone — the mirror's
// transparent CPU takeover (trie/resident_mirror.py) rides this.
void mpt_inc_mark_all_dirty(void* h) {
  Inc* t = (Inc*)h;
  walk_all(t->root, [](INode* n) {
    n->dirty = true;
    n->structural = true;
    n->enc_len = -1;  // plan recomputes RLP lengths for dirty nodes
  });
}

void mpt_inc_root(void* h, uint8_t* out32) {
  Inc* t = (Inc*)h;
  if (t->root)
    std::memcpy(out32, t->root->digest, 32);
  else
    std::memset(out32, 0, 32);
}

// ---- state reads (mirror-backed chain reads) ------------------------------

// Value lookup by 32-byte key. Returns the value length (copied into out
// when it fits cap), or -1 when the key is absent. This is the read seam
// the resident chain adapter serves StateDB misses from, replacing the
// host trie walk of trie/trie.py get() (reference trie/trie.go:87).
int64_t mpt_inc_get(void* h, const uint8_t* key32, uint8_t* out,
                    int64_t cap) {
  Inc* t = (Inc*)h;
  INode* n = t->root;
  int pos = 0;
  while (n) {
    if (n->kind == 2) {
      if (pos >= 64) return -1;
      n = n->child[nibble(key32, pos)];
      ++pos;
      continue;
    }
    if (pos + n->nnib > 64) return -1;
    for (int i = 0; i < n->nnib; ++i)
      if (n->frag[i] != nibble(key32, pos + i)) return -1;
    pos += n->nnib;
    if (n->kind == 0) {
      if (pos != 64) return -1;
      int64_t len = (int64_t)n->val.size();
      if (out && cap >= len) std::memcpy(out, n->val.data(), len);
      return len;
    }
    n = n->child[0];
  }
  return -1;
}

// ---- persistence sync point (interval commits) ----------------------------

// Pull device-store digests back into the host node cache. store is the
// executor's uint32[S, 8] read back as bytes (little-endian words — the
// same layout root_bytes renders); nodes whose slot is out of range keep
// their host digest. Resident commits defer absorption indefinitely; this
// is the explicit sync point the 4096-interval persistence uses
// (reference: trie/triedb/hashdb Commit, core/state_manager.go:153).
void mpt_inc_absorb_store(void* h, const uint8_t* store, int64_t n_slots) {
  Inc* t = (Inc*)h;
  walk_all(t->root, [&](INode* n) {
    if (n->slot >= 2 && n->slot < n_slots)
      std::memcpy(n->digest, store + (int64_t)n->slot * 32, 32);
  });
}

// Sharded variant of mpt_inc_absorb_store: absorb one CONTIGUOUS store
// partition [slot_lo, slot_hi) read back from a single mesh shard —
// part[0] is slot slot_lo's digest. Calling it once per shard pulls
// the whole device store into the host cache from shard-local d2h
// readbacks, with no host-side reassembly of the full store.
void mpt_inc_absorb_store_range(void* h, const uint8_t* part,
                                int64_t slot_lo, int64_t slot_hi) {
  Inc* t = (Inc*)h;
  walk_all(t->root, [&](INode* n) {
    if (n->slot >= 2 && n->slot >= slot_lo && n->slot < slot_hi)
      std::memcpy(n->digest, part + (int64_t)(n->slot - slot_lo) * 32, 32);
  });
}

// Count of hashed (enc_len >= 32) nodes + their total RLP bytes, for
// sizing mpt_inc_export_nodes buffers. Returns -1 if any node is dirty
// (digests/enc_len not settled — commit first).
int64_t mpt_inc_export_size(void* h, int64_t* total_rlp) {
  Inc* t = (Inc*)h;
  int64_t n_hashed = 0, bytes = 0;
  bool dirty = false;
  walk_all(t->root, [&](INode* n) {
    if (n->dirty || n->enc_len < 0) dirty = true;
    if (n->enc_len >= 32) {
      ++n_hashed;
      bytes += n->enc_len;
    }
  });
  if (dirty) return -1;
  *total_rlp = bytes;
  return n_hashed;
}

// Export every hashed node as (digest32, rlp) for the interval disk
// flush: digests -> uint8[n*32], rlp -> concatenated bytes with off[n+1]
// prefix offsets (off[0] = 0). Embedded (<32B) nodes inline into their
// parents exactly as the hashdb scheme stores them. Call
// mpt_inc_absorb_store first when the trie is resident-committed.
void mpt_inc_export_nodes(void* h, uint8_t* digests, uint8_t* rlp,
                          uint64_t* off) {
  Inc* t = (Inc*)h;
  RowWriter<LiteralPolicy> w{{}, rlp};  // base only feeds the (unused)
                                        // patch offset; must stay non-null
  int64_t i = 0;
  uint64_t pos = 0;
  off[0] = 0;
  walk_all(t->root, [&](INode* n) {
    n->unexported = false;  // a full image supersedes any pending delta
    if (n->enc_len < 32) return;
    std::memcpy(digests + i * 32, n->digest, 32);
    uint8_t* out = rlp + pos;
    w.write_node(n, out);
    pos += (uint64_t)n->enc_len;
    off[++i] = pos;
  });
}

// Delta variants: only nodes re-hashed since the last export (full or
// delta). Together with the previously exported image they form a
// complete hashdb overlay for the current root — unchanged subtrees keep
// their unchanged digests, so on-disk references stay valid. Same
// contract as the full export: digests must be settled (commit first;
// absorb_store first when resident-committed). Returns -1 while dirty.
int64_t mpt_inc_export_delta_size(void* h, int64_t* total_rlp) {
  Inc* t = (Inc*)h;
  int64_t n_hashed = 0, bytes = 0;
  bool dirty = false;
  walk_all(t->root, [&](INode* n) {
    if (n->dirty || n->enc_len < 0) dirty = true;
    if (n->unexported && n->enc_len >= 32) {
      ++n_hashed;
      bytes += n->enc_len;
    }
  });
  if (dirty) return -1;
  *total_rlp = bytes;
  return n_hashed;
}

void mpt_inc_export_delta_nodes(void* h, uint8_t* digests, uint8_t* rlp,
                                uint64_t* off) {
  Inc* t = (Inc*)h;
  RowWriter<LiteralPolicy> w{{}, rlp};
  int64_t i = 0;
  uint64_t pos = 0;
  off[0] = 0;
  walk_all(t->root, [&](INode* n) {
    if (!n->unexported) return;
    n->unexported = false;  // embedded nodes clear too: they ride inline
                            // in the parent row being exported this pass
    if (n->enc_len < 32) return;
    std::memcpy(digests + i * 32, n->digest, 32);
    uint8_t* out = rlp + pos;
    w.write_node(n, out);
    pos += (uint64_t)n->enc_len;
    off[++i] = pos;
  });
}

void mpt_inc_free(void* h) { delete (Inc*)h; }

}  // extern "C"
