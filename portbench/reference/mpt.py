"""Merkle-Patricia trie roots (Ethereum's hexary trie) in plain PyTorch,
batched: many tries at once (a forest, one trie per group), and many
versions of one key set at once (a block's changed leaves are a version).

Keys are 32-byte hashed keys, so every key has 64 nibbles and no value
sits in a branch. Every node this module hashes encodes to 32 bytes or
more (a leaf holds at least 55 nibbles of path for any realistic key
count, plus its value), so every child is referenced by its digest; a
node that would encode shorter raises, rather than being embedded.

The structure comes from the sorted keys alone: the longest common
prefix L[i] of keys i-1 and i (in nibbles, -1 across groups) says where
branches sit. A branch at depth d spans a maximal run of keys whose
adjacent prefixes are all >= d with one of them == d; its children start
at the run's first key and at each key i in it with L[i] == d. A node
spanning keys [s, e] hangs below the branch at depth max(L[s], L[e+1]),
through an extension when its own depth lies more than one nibble below.

Versions: version -1 is the base (every node), version k >= 0 the
update set k (a block). A node is re-hashed at version k when one of
its leaves changed at k; a branch at version k reads each child's digest
at the newest version <= k. The root of version k is the root node's
digest at the newest version <= k.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .keccak import keccak256

CHUNK = 1 << 16  # messages encoded and hashed per call
EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")
_I64_MIN = -(1 << 63)


class EmbeddedNodeError(ValueError):
    """A node encoded shorter than 32 bytes (this reference hashes every
    child; such a node would be embedded in its parent)."""


def _be_words(keys: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 32] -> int64 [M, 4] whose signed order is the keys'
    unsigned big-endian order."""
    w = keys.view(-1, 4, 8).flip(2).contiguous().view(torch.int64)
    return w.view(-1, 4) ^ _I64_MIN


def sort_keys(keys: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts (group, key) ascending."""
    words = _be_words(keys)
    order = torch.arange(keys.shape[0], device=keys.device)
    for col in (3, 2, 1, 0):
        idx = torch.sort(words[order, col], stable=True).indices
        order = order[idx]
    idx = torch.sort(group[order], stable=True).indices
    return order[idx]


def nibbles(keys: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 32] -> uint8 [M, 64]."""
    return torch.stack((keys >> 4, keys & 15), dim=2).view(-1, 64)


class Structure:
    """The node structure of a forest of tries over sorted keys.

    Node ids: leaves 0..M-1 (sorted key positions), branches M..M+nB-1.
    For each node: `first` (its first key), `pdepth` (depth of the branch
    above it, -1 at a root), `parent` (node id, -1 at a root), `slot`
    (nibble in the parent). Branches also have `depth` and `ext` (the
    nibble count of the extension above them); a leaf's path starts at
    pdepth + 1."""

    def __init__(self, keys: torch.Tensor, group: Optional[torch.Tensor] = None):
        dev = keys.device
        m = keys.shape[0]
        if group is None:
            group = torch.zeros(m, dtype=torch.int64, device=dev)
        self.order = sort_keys(keys, group)
        self.keys = keys.index_select(0, self.order)
        self.group = group.index_select(0, self.order)
        self.m = m
        self.device = dev
        nib = nibbles(self.keys)
        self.nib = nib
        ar = torch.arange(m, device=dev)
        lcp = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
        if m > 1:
            neq = nib[1:] != nib[:-1]
            if not bool(neq.any(1).all()):
                raise ValueError("duplicate key in a trie")
            first = neq.to(torch.int8).argmax(1)
            same = self.group[1:] == self.group[:-1]
            lcp[1:m] = torch.where(same, first, torch.full_like(first, -1))
        self.lcp = lcp  # lcp[i] = L[i]; lcp[0] = lcp[m] = -1
        maxd = int(lcp.max()) if m > 1 else -1
        # per depth d: start_d[i] = first key of i's depth-d run; end_d[i]
        # = its last key
        starts, ends = [], []
        for d in range(maxd + 1):
            brk = lcp[:m] < d
            s = torch.cummax(torch.where(brk, ar, torch.zeros_like(ar)),
                             0).values
            nxt = torch.where(lcp[1:m + 1] < d, ar + 1,
                              torch.full_like(ar, m))
            e = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values,
                           (0,)) - 1
            starts.append(s)
            ends.append(e)
        # branches: (depth, start) for each i with L[i] == d
        b_depth, b_first, b_last = [], [], []
        for d in range(maxd + 1):
            pos = (lcp[:m] == d).nonzero().flatten()
            if pos.numel() == 0:
                continue
            s = torch.unique(starts[d][pos])
            b_depth.append(torch.full_like(s, d))
            b_first.append(s)
            b_last.append(ends[d][s])
        if b_depth:
            b_depth = torch.cat(b_depth)
            b_first = torch.cat(b_first)
            b_last = torch.cat(b_last)
        else:
            b_depth = b_first = b_last = torch.zeros(0, dtype=torch.int64,
                                                     device=dev)
        nb = b_depth.numel()
        self.nb = nb
        self.n = m + nb
        # every node: first key, last key, own depth (leaves: 64)
        first = torch.cat((ar, b_first))
        last = torch.cat((ar, b_last))
        depth = torch.cat((torch.full((m,), 64, dtype=torch.int64,
                                      device=dev), b_depth))
        pdepth = torch.maximum(lcp[first], lcp[last + 1])
        self.first, self.depth, self.pdepth = first, depth, pdepth
        self.ext = depth - pdepth - 1  # branches only; leaves ignore it
        # parent: the branch (pdepth, start_pdepth(first))
        code = b_depth * (m + 1) + b_first
        code_sorted, code_idx = torch.sort(code)
        parent = torch.full((self.n,), -1, dtype=torch.int64, device=dev)
        pstart = torch.zeros(self.n, dtype=torch.int64, device=dev)
        for d in range(maxd + 1):
            sel = (pdepth == d).nonzero().flatten()
            if sel.numel():
                pstart[sel] = starts[d][first[sel]]
        has = pdepth >= 0
        want = pdepth.clamp(min=0) * (m + 1) + pstart
        j = torch.searchsorted(code_sorted, want).clamp(max=max(nb - 1, 0))
        if nb:
            ok = code_sorted[j] == want
            if not bool((ok | ~has).all()):
                raise RuntimeError("trie structure: a parent branch is missing")
            parent = torch.where(has, m + code_idx[j], parent)
        self.parent = parent
        slot = nib[first, pdepth.clamp(min=0)].to(torch.int64)
        self.slot = torch.where(has, slot, torch.full_like(slot, -1))
        # children table of each branch: [nB, 16] node ids, -1 empty
        self.children = torch.full((nb, 16), -1, dtype=torch.int64,
                                   device=dev)
        if nb:
            kid = has.nonzero().flatten()
            self.children[parent[kid] - m, self.slot[kid]] = kid
        self.roots = (~has).nonzero().flatten()  # one per group
        self.root_group = self.group[first[self.roots]]
        self.maxd = maxd


# ---- encodings --------------------------------------------------------------

def _compress(pieces: torch.Tensor, valid: torch.Tensor):
    """Row-wise: keep the valid bytes of each row, in order. Returns
    (rows uint8 [n, W], lengths int64 [n])."""
    lens = valid.sum(1)
    w = int(lens.max()) if lens.numel() else 1
    dest = valid.cumsum(1) - 1
    dest = torch.where(valid, dest, torch.full_like(dest, w))
    out = torch.zeros((pieces.shape[0], w + 1), dtype=torch.uint8,
                      device=pieces.device)
    out.scatter_(1, dest, pieces)
    return out[:, :w], lens


def _path_piece(nib_rows: torch.Tensor, start: torch.Tensor,
                count: torch.Tensor, leaf: bool):
    """RLP string of the hex-prefix encoding of nibbles
    nib_rows[i, start[i]:start[i]+count[i]]: (pieces uint8 [n, 34], valid
    bool [n, 34])."""
    n = nib_rows.shape[0]
    dev = nib_rows.device
    odd = count & 1
    flag = (2 if leaf else 0) + odd
    first_nib = nib_rows.gather(1, start.clamp(max=63)[:, None])[:, 0].long()
    b0 = (flag << 4) | torch.where(odd == 1, first_nib,
                                   torch.zeros_like(first_nib))
    j = torch.arange(32, device=dev)
    pos = (start + odd)[:, None] + 2 * j[None, :]
    hi = nib_rows.gather(1, pos.clamp(max=63)).long()
    lo = nib_rows.gather(1, (pos + 1).clamp(max=63)).long()
    pairs = (hi << 4) | lo
    clen = count // 2 + 1
    pieces = torch.cat(((0x80 + clen)[:, None], b0[:, None], pairs),
                       1).to(torch.uint8)
    valid = torch.cat(((clen > 1)[:, None],
                       torch.ones((n, 1), dtype=torch.bool, device=dev),
                       j[None, :] < (count // 2)[:, None]), 1)
    return pieces, valid, clen + (clen > 1).long()


def _list_header(payload: torch.Tensor):
    """RLP list header of each payload length (< 65536): pieces [n, 3],
    valid [n, 3]."""
    short = payload <= 55
    one = payload < 256
    b0 = torch.where(short, 0xC0 + payload,
                     torch.where(one, torch.full_like(payload, 0xF8),
                                 torch.full_like(payload, 0xF9)))
    b1 = torch.where(one, payload & 0xFF, payload >> 8)
    b2 = payload & 0xFF
    pieces = torch.stack((b0, b1, b2), 1).to(torch.uint8)
    valid = torch.stack((torch.ones_like(short), ~short, ~one), 1)
    return pieces, valid


def _hash_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    if bool((lens < 32).any()):
        raise EmbeddedNodeError("a trie node encodes shorter than 32 bytes")
    return keccak256(rows, lens)


def leaf_digests(nib_rows, pstart, vals, vlens) -> torch.Tensor:
    """Digests of leaf nodes: path nib_rows[i, pstart[i]:64], value bytes
    vals[i, :vlens[i]] (already RLP, stored as an RLP string)."""
    dev = nib_rows.device
    count = 64 - pstart
    ppieces, pvalid, plen = _path_piece(nib_rows, pstart, count, True)
    vl = vlens.long()
    v0 = vals[:, 0].long()
    single = (vl == 1) & (v0 < 0x80)
    short = vl <= 55
    h0 = torch.where(short, 0x80 + vl, torch.full_like(vl, 0xB8))
    h1 = vl & 0xFF
    hpieces = torch.stack((h0, h1), 1).to(torch.uint8)
    hvalid = torch.stack((~single, ~short), 1)
    vcol = torch.arange(vals.shape[1], device=dev)
    vvalid = vcol[None, :] < vl[:, None]
    payload = plen + hvalid.sum(1) + vl
    lpieces, lvalid = _list_header(payload)
    rows, lens = _compress(torch.cat((lpieces, ppieces, hpieces, vals), 1),
                           torch.cat((lvalid, pvalid, hvalid, vvalid), 1))
    return _hash_rows(rows, lens)


def ext_digests(nib_rows, pstart, count, child) -> torch.Tensor:
    """Digests of extension nodes over nib_rows[i, pstart:pstart+count]
    pointing at the 32-byte digests child[i]."""
    n = nib_rows.shape[0]
    dev = nib_rows.device
    ppieces, pvalid, plen = _path_piece(nib_rows, pstart, count, False)
    ref = torch.cat((torch.full((n, 1), 0xA0, dtype=torch.uint8, device=dev),
                     child), 1)
    lpieces, lvalid = _list_header(plen + 33)
    rows, lens = _compress(
        torch.cat((lpieces, ppieces, ref), 1),
        torch.cat((lvalid, pvalid, torch.ones((n, 33), dtype=torch.bool,
                                              device=dev)), 1))
    return _hash_rows(rows, lens)


def branch_digests(child_digests: torch.Tensor,
                   present: torch.Tensor) -> torch.Tensor:
    """Digests of branch nodes from their 16 children's digests
    (uint8 [n, 16, 32]) where present (bool [n, 16]); no value."""
    n = child_digests.shape[0]
    dev = child_digests.device
    payload = 17 + 32 * present.sum(1)
    lpieces, lvalid = _list_header(payload)
    tag = torch.where(present, torch.full_like(present, 0xA0, dtype=torch.uint8),
                      torch.full_like(present, 0x80, dtype=torch.uint8))
    slots = torch.cat((tag[:, :, None], child_digests), 2).view(n, 16 * 33)
    svalid = torch.cat((torch.ones((n, 16, 1), dtype=torch.bool, device=dev),
                        present[:, :, None].expand(n, 16, 32)), 2)
    svalid = svalid.reshape(n, 16 * 33)
    end = torch.full((n, 1), 0x80, dtype=torch.uint8, device=dev)
    rows, lens = _compress(
        torch.cat((lpieces, slots, end), 1),
        torch.cat((lvalid, svalid, torch.ones((n, 1), dtype=torch.bool,
                                              device=dev)), 1))
    return _hash_rows(rows, lens)


# ---- versioned roots -----------------------------------------------------------

class _Versions:
    """Digest of each (node, version) computed so far, searchable for the
    newest version <= k of a node. A node's digest here is its reference
    in its parent: a branch under an extension is stored as the
    extension's digest."""

    def __init__(self, nversions: int, device):
        self.span = nversions + 1  # version -1 -> 0
        self.codes: List[torch.Tensor] = []
        self.digs: List[torch.Tensor] = []
        self.sorted_codes = None
        self.sorted_digs = None
        self.device = device

    def add(self, node, version, dig) -> None:
        self.codes.append(node * self.span + version + 1)
        self.digs.append(dig)
        self.sorted_codes = None

    def _sort(self):
        if self.sorted_codes is None:
            codes = torch.cat(self.codes)
            digs = torch.cat(self.digs)
            order = torch.argsort(codes)
            self.codes, self.digs = [codes[order]], [digs[order]]
            self.sorted_codes, self.sorted_digs = self.codes[0], self.digs[0]

    def lookup(self, node, version) -> torch.Tensor:
        """Digests [n, 32] of `node` at its newest version <= `version`
        (every node has version -1)."""
        self._sort()
        want = node * self.span + version + 1
        j = torch.searchsorted(self.sorted_codes, want, right=True) - 1
        if bool((self.sorted_codes[j.clamp(min=0)] // self.span != node).any()):
            raise RuntimeError("trie versions: a node has no base version")
        return self.sorted_digs[j]


def _chunks(n: int, size: int = CHUNK):
    for a in range(0, n, size):
        yield a, min(n, a + size)


def roots(st: Structure, vals: torch.Tensor, vlens: torch.Tensor,
          updates: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
          = (), chunk: int = CHUNK) -> torch.Tensor:
    """Roots of every group at every version.

    vals, vlens: the base value of each key in the caller's key order
    (uint8 [M, V], int64 [M]). updates[k] = (key indices in the caller's
    order, uint8 rows [u, V'], int64 lengths [u]): the values set at
    version k (the last of duplicate indices wins). Returns uint8
    [K + 1, G, 32]: row 0 the base roots, row k + 1 those after update
    set k, G the groups in ascending order."""
    dev = st.device
    m, k_n = st.m, len(updates)
    ver = _Versions(k_n, dev)
    inv = torch.empty_like(st.order)
    inv[st.order] = torch.arange(m, device=dev)
    # leaves: (leaf, version, value rows)
    leaf_node = [torch.arange(m, device=dev)]
    leaf_ver = [torch.full((m,), -1, dtype=torch.int64, device=dev)]
    leaf_src = [(vals.index_select(0, st.order), vlens.index_select(0, st.order))]
    for k, (idx, rows, lens) in enumerate(updates):
        pos = inv[idx.to(dev)]
        # the last write of a key in the set wins
        rev = torch.flip(torch.arange(pos.numel(), device=dev), (0,))
        uniq, first_in_rev = _first_occurrence(torch.flip(pos, (0,)))
        keep = rev[first_in_rev]
        leaf_node.append(uniq)
        leaf_ver.append(torch.full_like(uniq, k))
        leaf_src.append((rows.to(dev)[keep], lens.to(dev)[keep]))
    for node, version, (rows, lens) in zip(leaf_node, leaf_ver, leaf_src):
        for a, b in _chunks(node.numel(), chunk):
            nd = node[a:b]
            dig = leaf_digests(st.nib[st.first[nd]], st.pdepth[nd] + 1,
                               rows[a:b], lens[a:b])
            ver.add(nd, version[a:b], dig)
    all_node = torch.cat(leaf_node)
    all_ver = torch.cat(leaf_ver)
    for d in range(st.maxd, -1, -1):
        # dirty (branch, version) pairs at depth d: parents of computed
        # (child, version) pairs whose parent sits at depth d
        sel = (st.pdepth[all_node] == d).nonzero().flatten()
        if sel.numel() == 0:
            continue
        par = st.parent[all_node[sel]]
        pv = all_ver[sel]
        code = torch.unique(par * (k_n + 1) + pv + 1)
        bnode = code // (k_n + 1)
        bver = code % (k_n + 1) - 1
        new_node, new_ver = [], []
        for a, b in _chunks(bnode.numel(), chunk):
            nd, vv = bnode[a:b], bver[a:b]
            kids = st.children[nd - m]  # [n, 16]
            present = kids >= 0
            flat_kid = kids.clamp(min=0).reshape(-1)
            flat_ver = vv[:, None].expand(-1, 16).reshape(-1)
            cd = ver.lookup(flat_kid, flat_ver).view(-1, 16, 32)
            cd = torch.where(present[:, :, None], cd, torch.zeros_like(cd))
            dig = branch_digests(cd, present)
            ext = st.ext[nd]
            has_ext = ext > 0
            if bool(has_ext.any()):
                e = has_ext.nonzero().flatten()
                en = nd[e]
                dig[e] = ext_digests(st.nib[st.first[en]], st.pdepth[en] + 1,
                                     ext[e], dig[e])
            ver.add(nd, vv, dig)
            new_node.append(nd)
            new_ver.append(vv)
        all_node = torch.cat([all_node] + new_node)
        all_ver = torch.cat([all_ver] + new_ver)
    # roots at each version
    g = st.roots.numel()
    rnode = st.roots[None, :].expand(k_n + 1, g).reshape(-1)
    rver = (torch.arange(k_n + 1, device=dev) - 1)[:, None].expand(
        k_n + 1, g).reshape(-1)
    out = ver.lookup(rnode, rver).view(k_n + 1, g, 32)
    order = torch.argsort(st.root_group)
    return out[:, order]


def _first_occurrence(x: torch.Tensor):
    """(unique values of x, index of each value's first occurrence in x)."""
    uniq, inv = torch.unique(x, return_inverse=True)
    idx = torch.arange(x.numel(), device=x.device)
    first = torch.full((uniq.numel(),), x.numel(), dtype=torch.int64,
                       device=x.device)
    first.scatter_reduce_(0, inv, idx, reduce="amin")
    return uniq, first


def root_of_items(items, device="cpu") -> bytes:
    """The root of one trie over (32-byte key, value bytes) items: a
    convenience for tests; the empty trie's root when there are none."""
    if not items:
        return EMPTY_ROOT
    keys = torch.tensor([list(k) for k, _ in items], dtype=torch.uint8,
                        device=device)
    w = max(len(v) for _, v in items)
    vals = torch.zeros((len(items), w), dtype=torch.uint8)
    for i, (_, v) in enumerate(items):
        vals[i, :len(v)] = torch.tensor(list(v), dtype=torch.uint8)
    lens = torch.tensor([len(v) for _, v in items], dtype=torch.int64)
    st = Structure(keys)
    return bytes(roots(st, vals.to(device), lens.to(device))[0, 0]
                 .cpu().tolist())
