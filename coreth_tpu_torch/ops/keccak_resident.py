"""Device-resident incremental trie commits in torch: the counterpart of
coreth_tpu/ops/keccak_resident.py (ResidentExecutor).

The planned executor (ops/keccak_planned.py) re-ships every dirty node's
full row each commit and reads the whole digest matrix back. This executor
keeps both halves of that traffic on the device across commits:

  - a digest STORE int32[S, 8] (u32 bits) holds every node's digest at a
    persistent slot; parents reference children by slot, so digests never
    return to the host (only the 32-byte root, on demand)
  - per block-class row ARENAS int32[R, blocks*34] hold each node's
    keccak-padded RLP row at a persistent row index; a commit uploads only
    rows whose template changed (fresh nodes, structural edits) plus the
    patch tables
  - holes are DELTA-patched: strips of (new - old) child digests are added
    into the arena in wrapping 32-bit arithmetic. Every hole word is a sum
    of byte-disjoint contributions, so the modular update is exact; fresh
    rows carry zero holes and old = the zero sentinel. The old digest is
    store[slot] before this commit's store scatter, which runs last.

Each segment's rows are gathered from its arena and hashed by one segment
Keccak call: ops/keccak_cuda.segment_keccak, kernel K1 on a CUDA tensor and
its plain version on a CPU one. K1 takes the place of both the reference's
XLA scan (keccak_staged._segment_keccak, the executor's default there) and
the Pallas kernel.

Index conventions (native/mpt_inc.cpp build_plan_res): store slot 0 =
zero sentinel, slot 1 = pad-lane scratch, real slots >= 2; arena row 0 of
each class = scratch; dig row 0 = zero sentinel. JAX drops an out-of-range
scatter index (mode="drop"); torch on CUDA would assert and poison the
context, so every arena is allocated with one scratch word past its rows
and a patch strip word past the rows lands there instead (never clamped).
The arenas stay int32, the bit pattern K1 reads: strips are computed in
int64, narrowed to int32 two's-complement bits and index_add_-ed (which
wraps, and accumulates where neighbouring holes' 9-word strips overlap).

A commit is the reference's fused form: one upload of the packed fresh
rows and one of every index table (pinned host staging on CUDA,
non_blocking), then the fresh-row scatters, the lean expansion, each
segment's delta patch, gather and K1, and the store scatter, all queued on
the executor's stream with no host synchronisation until the root is read.
The staging buffers form a ring of `pipeline_depth` + 1 entries; an entry
is refilled only once the CUDA event recorded after its upload has
completed, so up to `pipeline_depth` commits may be in flight.

The stream is the one current when the executor is built, and every
enqueue and readback runs under it, whichever thread calls: torch's
current stream is per thread, and the device watchdog
(native/mpt._run_with_watchdog) runs commits and root readbacks on a
worker thread.

Not ported: `sharding=` (multi-GPU, ROADMAP "Still to port", item 6), the
reference's per-segment form (`fused=False`) and its
CORETH_TPU_RESIDENT_FUSE environment switch.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .keccak_planned import _strips
from .keccak_torch import MASK32, WORDS_PER_BLOCK, to_int32

MAX_SEGMENTS = 64
LEAN_WORDS = 18  # 72-byte lean record = 18 u32 words (native kLeanWidth)
_STAGING_SLACK = 1 << 16  # words a staging buffer may hold beyond 4x need
_SIGN_BIT = -(1 << 31)  # 0x80 << 24 as int32 bits


def _pow2_bucket(n: int, floor: int = 16) -> int:
    """Round n up to a power of two (>= floor). Every padded shape comes
    from this one policy, so a steady state repeats the same shapes."""
    b = floor
    while b < n:
        b <<= 1
    return b


class ResidentExecutor:
    """Holds one trie's device-resident state (store + arenas) and runs the
    resident commits exported by native/mpt.IncrementalTrie.

    One executor per trie: the store and arena contents are that trie's
    digest cache. `device`: None is CUDA (raises without it), "cpu" only
    when asked. `seg_impl`: the segment keccak, int32[P, L, 34] ->
    int32[P, 8] (default keccak_cuda.segment_keccak: K1 on CUDA), kept as
    the public attribute of that name, which a caller may swap for a
    wrapper that launches the same kernel (a recorder).

    After every run(): h2d_bytes and last_transfers (the commit's host to
    device traffic), last_dispatches (host-level steps, counted as the
    reference counts its programs), last_lean_rows and last_lean_wire_bytes,
    last_dig (the commit's digest matrix with the zero row 0, on the
    device) and last_root (its root row); on CUDA, last_events holds the
    events recorded before the first upload, after the uploads and after
    the store scatter, and last_done is the last of them (None on the
    CPU): a reader on another thread waits on it before reading."""

    def __init__(self, seg_impl=None, sharding=None,
                 device: DeviceLike = None, pipeline_depth: int = 0):
        if sharding is not None:
            raise NotImplementedError(
                "a sharded resident executor is not ported (ROADMAP 'Still "
                "to port', item 6: multi-GPU)")
        self.device = resolve(device)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        if seg_impl is None:
            from .keccak_cuda import segment_keccak as seg_impl
        self.seg_impl = seg_impl
        self.pipeline_depth = pipeline_depth
        self.store: Optional[torch.Tensor] = None      # int32[S, 8]
        self._flat: Dict[int, torch.Tensor] = {}       # class -> rows + 1 word
        self._rows: Dict[int, int] = {}                # class -> row capacity
        self.last_root = None                          # lazy int32[8]
        self.last_dig: Optional[torch.Tensor] = None
        self.last_events = None
        self.last_done = None
        self._owner = None
        self._ring: list = []  # [(aux, rows, upload event or None)]
        self.h2d_bytes = 0
        self.last_transfers = 0
        self.last_dispatches = 0
        self.last_lean_rows = 0
        self.last_lean_wire_bytes = 0

    @property
    def arenas(self) -> Dict[int, torch.Tensor]:
        """class -> int32[R, class*34] view of its arena (the scratch word
        past the rows excluded)."""
        return {cls: self._arena(cls) for cls in sorted(self._flat)}

    def _arena(self, cls: int) -> torch.Tensor:
        width = cls * WORDS_PER_BLOCK
        rows = self._rows[cls]
        return self._flat[cls][:rows * width].view(rows, width)

    def device_bytes(self) -> int:
        """Bytes the store and the arenas hold on the device."""
        n = 0 if self.store is None else self.store.numel() * 4
        return n + sum(f.numel() * 4 for f in self._flat.values())

    def _on_stream(self):
        """The executor's stream made current on the calling thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        with self._on_stream():
            return t.cpu().numpy()

    def store_parts(self):
        """[(slot_lo, slot_hi, uint32[S, 8])]: the whole store in one part
        (unsharded), for IncrementalTrie.absorb_store_parts."""
        if self.store is None:
            return []
        return [(0, int(self.store.shape[0]),
                 self._host(self.store).view(np.uint32))]

    def host_digests(self) -> np.ndarray:
        """The last commit's digest matrix uint32[1 + G, 8] on the host
        (row 0 the zero sentinel): template residency absorbs it."""
        return self._host(self.last_dig).view(np.uint32)

    # ---- ownership: slot and row numbering is per trie ----

    def check_binding(self, tree):
        if self._owner is not None and self._owner() is not tree:
            raise RuntimeError(
                "executor already serves another trie (its store/arena "
                "slots are that trie's digest cache); create one "
                "ResidentExecutor per trie")

    def bind(self, tree):
        self.check_binding(tree)
        if self._owner is None:
            self._owner = weakref.ref(tree)

    # ---- capacity (geometric growth, as the reference) ----

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _ensure_store(self, slots_needed: int):
        if self.store is None:
            self.store = self._zeros(max(2 * slots_needed, 4096), 8)
        elif self.store.shape[0] < slots_needed:
            cap = max(2 * slots_needed, 2 * self.store.shape[0])
            grown = self._zeros(cap, 8)
            grown[:self.store.shape[0]] = self.store
            self.store = grown

    def _ensure_arena(self, cls: int, rows_needed: int):
        width = cls * WORDS_PER_BLOCK
        rows = self._rows.get(cls)
        if rows is None:
            cap = max(2 * rows_needed, 1024)
        elif rows < rows_needed:
            cap = max(2 * rows_needed, 2 * rows)
        else:
            return
        flat = self._zeros(cap * width + 1)  # + the scratch word
        if rows is not None:
            flat[:rows * width] = self._flat[cls][:rows * width]
        self._flat[cls] = flat
        self._rows[cls] = cap

    # ---- the device steps ----

    def _patch(self, cls: int, store, dig, off, src, oldidx) -> None:
        """Add one segment's (new - old) strips into the class's arena."""
        flat = self._flat[cls]
        scratch = flat.shape[0] - 1
        src = src.long()
        # signed source: +k = this commit's dig row k, -k = store slot k,
        # 0 = none (both gathers hit their all-zero row 0)
        new = torch.where(src[:, None] > 0, dig[src.clamp(min=0)],
                          store[(-src).clamp(min=0)])
        old = store[oldidx.long()]
        off = off.long()
        shift = off & 3
        delta = (_strips(new, shift) - _strips(old, shift)) & MASK32
        idx = ((off >> 2)[:, None]
               + torch.arange(9, dtype=torch.int64, device=flat.device)
               ).reshape(-1)
        idx = torch.where((idx >= 0) & (idx < scratch), idx,
                          torch.full_like(idx, scratch))
        flat.index_add_(0, idx, to_int32(delta.reshape(-1)))

    def _hash_segment(self, cls: int, lanes: int, gstart: int, dig,
                      ridx) -> None:
        words = self._arena(cls).index_select(0, ridx.long())
        out = self.seg_impl(words.view(lanes, cls, WORDS_PER_BLOCK))
        dig[gstart + 1:gstart + 1 + lanes] = out

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ---- host staging ----

    def _staging(self, n_aux: int, n_rows: int):
        """Host buffers (aux, rows) of at least n_aux and n_rows int32
        words: the ring's oldest entry once the upload that last read it
        has completed, while the ring holds pipeline_depth + 1 entries,
        else new ones. A buffer too small, or more than four times too
        large (after the genesis' outsized upload), is replaced."""
        want = max(0, int(self.pipeline_depth)) + 1
        while len(self._ring) > want:  # depth was lowered: shrink the ring
            self._ring.pop(0)
        aux_t = rows_t = None
        if len(self._ring) == want:
            aux_t, rows_t, uploaded = self._ring.pop(0)
            if uploaded is not None:
                uploaded.synchronize()
        return self._fit(aux_t, n_aux), self._fit(rows_t, max(n_rows, 1))

    def _fit(self, buf, n: int) -> torch.Tensor:
        if buf is not None and n <= buf.numel() <= 4 * n + _STAGING_SLACK:
            return buf
        return torch.empty(n + n // 4, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")

    # ---- one commit ----

    def run(self, export) -> torch.Tensor:
        """Execute one resident commit on the executor's stream. `export`
        is the dict of native.mpt.IncrementalTrie.export_resident_plan().
        Returns the root digest as a lazy int32[8] on the device;
        root_bytes() reads it."""
        with self._on_stream():
            return self._run(export)

    def _run(self, export) -> torch.Tensor:
        specs = export["specs"]            # [n_seg, 6] int32 host array
        if len(specs) > MAX_SEGMENTS:
            raise ValueError(f"{len(specs)} segments > {MAX_SEGMENTS}")
        self._ensure_store(export["store_slots"])
        for cls, (_n_fresh, rows_needed) in export["classes"].items():
            self._ensure_arena(cls, rows_needed)
        # (blocks, lanes, gstart, n_patches, patch_off, lane_off)
        specs_t = tuple(tuple(int(v) for v in s) for s in specs)
        g_pad = _pow2_bucket(int(export["total_lanes"]))
        fresh_shapes = []
        for cls in sorted(export["fresh"]):
            rows, idx = export["fresh"][cls]
            fresh_shapes.append((cls, rows, idx, _pow2_bucket(idx.shape[0])))
        len_off = export["off"].shape[0]
        len_rowidx = export["rowidx"].shape[0]
        lean = export.get("lean")
        n_lean = lean[1].shape[0] if lean is not None else 0
        lean_bucket = _pow2_bucket(n_lean) if n_lean else 0
        fresh_t = tuple((cls, bucket, rows.shape[1])
                        for cls, rows, _, bucket in fresh_shapes)
        classes = tuple(sorted({s[0] for s in specs_t}
                               | {cls for cls, _, _ in fresh_t}))
        for cls in classes:
            self._ensure_arena(cls, 1)  # segment-only classes must exist
        n_aux = (3 * len_off + len_rowidx + g_pad
                 + sum(b for _, b, _ in fresh_t) + 2 * lean_bucket)
        n_rows = (sum(b * w for _, b, w in fresh_t)
                  + lean_bucket * LEAN_WORDS)
        aux_t, rows_t = self._staging(n_aux, n_rows)
        aux, rows_packed = aux_t.numpy(), rows_t.numpy().view(np.uint32)

        p = 0
        aux[p:p + len_off] = export["off"]; p += len_off
        aux[p:p + len_off] = export["src"]; p += len_off
        aux[p:p + len_off] = export["oldidx"]; p += len_off
        aux[p:p + len_rowidx] = export["rowidx"]; p += len_rowidx
        n_ls = export["lane_slot"].shape[0]
        aux[p:p + n_ls] = export["lane_slot"]
        aux[p + n_ls:p + g_pad] = 1  # pad lanes -> scratch slot
        p += g_pad
        rp = 0
        for cls, rows, idx, bucket in fresh_shapes:
            n, w = idx.shape[0], rows.shape[1]
            aux[p:p + n] = idx
            aux[p + n:p + bucket] = 0  # pad rows -> arena scratch row
            p += bucket
            rows_packed[rp:rp + n * w] = rows.reshape(-1)
            rows_packed[rp + n * w:rp + bucket * w] = 0
            rp += bucket * w
        if lean_bucket:
            lrows, lidx, llen = lean
            aux[p:p + n_lean] = lidx
            aux[p + n_lean:p + lean_bucket] = 0  # pads -> scratch row
            p += lean_bucket
            aux[p:p + n_lean] = llen
            aux[p + n_lean:p + lean_bucket] = 0  # pad len 0
            p += lean_bucket
            nw = n_lean * LEAN_WORDS
            rows_packed[rp:rp + nw] = lrows.reshape(-1)
            rows_packed[rp + nw:rp + lean_bucket * LEAN_WORDS] = 0
            rp += lean_bucket * LEAN_WORDS
        self.last_lean_rows = n_lean
        self.last_lean_wire_bytes = n_lean * (4 * LEAN_WORDS + 8)

        cuda = self.device.type == "cuda"
        t0 = self._event() if cuda else None
        rows_d = rows_t[:rp].to(self.device, non_blocking=True)
        aux_d = aux_t[:n_aux].to(self.device, non_blocking=True)
        t_up = self._event() if cuda else None
        self._ring.append((aux_t, rows_t, t_up))
        self.h2d_bytes = rp * 4 + n_aux * 4
        self.last_transfers = 2
        self.last_dispatches = 1

        p = 0
        off_all = aux_d[p:p + len_off]; p += len_off
        src_all = aux_d[p:p + len_off]; p += len_off
        oldidx_all = aux_d[p:p + len_off]; p += len_off
        rowidx_all = aux_d[p:p + len_rowidx]; p += len_rowidx
        lane_slot = aux_d[p:p + g_pad]; p += g_pad
        rp = 0
        for cls, n_rows, width in fresh_t:
            idx = aux_d[p:p + n_rows]; p += n_rows
            rows = rows_d[rp:rp + n_rows * width].view(n_rows, width)
            rp += n_rows * width
            self._arena(cls).index_copy_(0, idx.long(), rows)
        if lean_bucket:
            # zero-extend each 18-word record to a 34-word class-1 row and
            # set the keccak pad bits from the RLP length (0x01 at byte len,
            # 0x80 at byte 135; both bytes are zero in a lean record); pad
            # records (row 0, len 0) land in the scratch row
            lidx = aux_d[p:p + lean_bucket].long(); p += lean_bucket
            llen = aux_d[p:p + lean_bucket].long(); p += lean_bucket
            lrows = rows_d[rp:rp + lean_bucket * LEAN_WORDS]
            full = self._zeros(lean_bucket, WORDS_PER_BLOCK)
            full[:, :LEAN_WORDS] = lrows.view(lean_bucket, LEAN_WORDS)
            lane = torch.arange(lean_bucket, device=self.device)
            full.index_put_((lane, llen >> 2),
                            (1 << ((llen & 3) * 8)).to(torch.int32),
                            accumulate=True)
            full[:, WORDS_PER_BLOCK - 1] |= _SIGN_BIT
            self._arena(1).index_copy_(0, lidx, full)
        dig = self._zeros(1 + g_pad, 8)
        for blocks, lanes, gstart, npatch, patch_off, lane_off in specs_t:
            if npatch:
                sl = slice(patch_off, patch_off + npatch)
                self._patch(blocks, self.store, dig, off_all[sl], src_all[sl],
                            oldidx_all[sl])
            self._hash_segment(blocks, lanes, gstart, dig,
                               rowidx_all[lane_off:lane_off + lanes])
        # the store scatter runs last (the patches read the old digests);
        # pad lanes target the scratch slot 1, so the duplicate indices
        # there are harmless, and slot 0 is never written
        self.store.index_copy_(0, lane_slot.long(), dig[1:])
        if t0 is not None:
            self.last_events = (t0, t_up, self._event())
            self.last_done = self.last_events[2]
        self.last_dig = dig
        self.last_root = dig[int(export["root_lane"]) + 1]
        return self.last_root

    def root_bytes(self, root) -> bytes:
        """Synchronise and render a run() result (or a host array of 8
        words) as the 32-byte root, read on the executor's stream."""
        if isinstance(root, torch.Tensor):
            root = self._host(root)
        return np.ascontiguousarray(root).view(np.uint32).astype(
            "<u4").tobytes()
