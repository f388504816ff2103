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
The arenas stay int32, the bit pattern K1 reads. A segment's delta patch
is kernel K3 (ops/keccak_cuda.resident_patch, csrc/resident_patch.cu),
one launch a segment with patches, on a CUDA tensor: it reads the
uploaded tables through pointers and adds each strip word with a 32-bit
atomic. Its plain version, resident_patch_plain below, runs for CPU
tensors: strips computed in int64, narrowed to int32 two's-complement
bits and index_add_-ed. Both wrap, and accumulate where neighbouring
holes' 9-word strips overlap.

A commit is the reference's fused form: one upload of the packed fresh
rows and one of every index table (pinned host staging on CUDA,
non_blocking), then the fresh-row scatters, the lean expansion, each
segment's delta patch (K3), gather and K1, and the store scatter, all
queued on the executor's stream with no host synchronisation until the
root is read.
The staging buffers form a ring of `pipeline_depth` + 1 entries; an entry
is refilled only once the CUDA event recorded after its upload has
completed, so up to `pipeline_depth` commits may be in flight.

The stream is the one current when the executor is built, and every
enqueue and readback runs under it, whichever thread calls: torch's
current stream is per thread, and the device watchdog
(native/mpt._run_with_watchdog) runs commits and root readbacks on a
worker thread.

Sharded (`sharding=`, parallel.resident_executor_over_mesh): the store
and every arena class are split into contiguous row blocks, one per shard
device (capacities round up to a multiple of the shard count), and the
owner of a slot or row is min(index // block, shards - 1). A commit is
partitioned on the host: the same two uploads go to the first shard
device (and by device copy to each other distinct device), every store
slot a patch reads is gathered from its owner up front (the store scatter
runs last, so they all read the store as it was), then per segment the
delta strips are computed by torch ops (not K3) beside the digest
matrix, which stays on the first device (a later patch may read any
earlier lane), and added into
the shard that owns the parent row; K1 runs per shard over the lanes
whose rows it owns, and the store scatter writes each digest to its
slot's owner. One shard is the unsharded form on that device.

Not ported: the reference's per-segment form (`fused=False`) and its
CORETH_TPU_RESIDENT_FUSE environment switch.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..metrics import PhaseSeq, phase_timer
from . import keccak_cuda
from .keccak_planned import _strips
from .keccak_torch import MASK32, WORDS_PER_BLOCK, to_int32

MAX_SEGMENTS = 64
LEAN_WORDS = 18  # 72-byte lean record = 18 u32 words (native kLeanWidth)
_STAGING_SLACK = 1 << 16  # words a staging buffer may hold beyond 4x need
_SIGN_BIT = -(1 << 31)  # 0x80 << 24 as int32 bits


def _count(name: str, n: int) -> None:
    from ..metrics import default_registry

    default_registry.counter(name).inc(n)


def resident_patch_plain(flat: torch.Tensor, store: torch.Tensor,
                         dig: torch.Tensor, off: torch.Tensor,
                         src: torch.Tensor, oldidx: torch.Tensor) -> None:
    """Kernel K3's plain version (keccak_cuda.resident_patch takes it for
    CPU tensors): add one segment's (new - old) strips into a class's flat
    arena (the scratch word last), in place. off, src, oldidx: the
    segment's int32 patch tables."""
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
    device traffic), last_lean_rows and last_lean_wire_bytes, last_dig
    (the commit's digest matrix with the zero row 0, on the device) and
    last_root (its root row), last_patch_launches (K3 launches, one a
    segment with patches; 0 on the CPU and when sharded); on CUDA,
    last_events holds the
    events recorded before the first upload, after the uploads and after
    the store scatter, and last_done is the last of them (None on the
    CPU): a reader on another thread waits on it before reading."""

    def __init__(self, seg_impl=None, sharding=None,
                 device: DeviceLike = None, pipeline_depth: int = 0):
        # sharding (parallel.RowSharding): the resident state split by
        # rows over its devices; the first is the executor's own device
        self.sharding = sharding
        if sharding is not None:
            self.shard_devices = [resolve(d) for d in sharding.devices]
            if device is not None and resolve(device) != \
                    self.shard_devices[0]:
                raise ValueError(
                    f"device {device} is not the sharding's first device "
                    f"{self.shard_devices[0]}")
            self.device = self.shard_devices[0]
        else:
            self.device = resolve(device)
            self.shard_devices = [self.device]
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        # the current stream of every other CUDA device the shards use
        self._peer_streams = [
            torch.cuda.current_stream(d)
            for d in dict.fromkeys(self.shard_devices)
            if d.type == "cuda" and d != self.device]
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
        self.last_lean_rows = 0
        self.last_lean_wire_bytes = 0
        self.last_patch_launches = 0
        # sharded state: per shard, the store's and each arena's row block
        # (+ one scratch word past an arena block's rows)
        self._store_parts: list = []
        self._store_cap = 0
        self._flat_parts: Dict[int, list] = {}
        # mesh accounting, explicit zeros when unsharded so flight-record
        # keys stay un-ragged: last_gather_bytes is MEASURED (a full digest
        # matrix read back from a sharded commit, note_dig_gather), the
        # _modeled twin the (n-1)/n all-gather a sharded commit implies,
        # last_absorb_d2h_bytes the shard-local readbacks that replace it,
        # last_shard_lanes the commit's lanes per store shard
        self.last_gather_bytes = 0
        self.last_gather_bytes_modeled = 0
        self.last_absorb_d2h_bytes = 0
        self.last_shard_lanes: list = []

    @property
    def shards(self) -> int:
        """Shards holding the resident state (1 = unsharded)."""
        return len(self.shard_devices)

    @property
    def spans_processes(self) -> bool:
        """True when the mesh's positions belong to more than one process:
        the mirror's single-device rung is then unavailable (a unilateral
        local rebuild would desync the other processes)."""
        if self.sharding is None:
            return False
        from ..parallel import mesh_spans_processes

        return mesh_spans_processes(self.sharding.mesh)

    def _cap(self, n: int) -> int:
        """Capacities round up to a multiple of the shard count."""
        m = self.shards
        return -(-n // m) * m

    @property
    def store_capacity(self) -> int:
        if self.shards > 1:
            return self._store_cap
        return 0 if self.store is None else int(self.store.shape[0])

    @property
    def arenas(self) -> Dict[int, torch.Tensor]:
        """class -> int32[R, class*34] view of its arena (the scratch word
        past the rows excluded); unsharded executors only."""
        return {cls: self._arena(cls) for cls in sorted(self._flat)}

    def _arena(self, cls: int) -> torch.Tensor:
        width = cls * WORDS_PER_BLOCK
        rows = self._rows[cls]
        return self._flat[cls][:rows * width].view(rows, width)

    def device_bytes(self) -> int:
        """Bytes the store and the arenas hold on the device(s)."""
        n = 0 if self.store is None else self.store.numel() * 4
        n += sum(p.numel() * 4 for p in self._store_parts)
        n += sum(f.numel() * 4 for parts in self._flat_parts.values()
                 for f in parts)
        return n + sum(f.numel() * 4 for f in self._flat.values())

    def _on_stream(self):
        """The executor's streams made current on the calling thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        if not self._peer_streams:
            return torch.cuda.stream(self.stream)
        stack = contextlib.ExitStack()
        for s in [self.stream] + self._peer_streams:
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def _host(self, t: torch.Tensor) -> np.ndarray:
        with self._on_stream():
            return t.cpu().numpy()

    def store_parts(self):
        """[(slot_lo, slot_hi, uint32[rows, 8])]: the store, one part per
        shard (one in all when unsharded), each read back from its own
        device, for IncrementalTrie.absorb_store_parts. Counted in
        resident/absorb_d2h_bytes."""
        if self._store_parts:
            per = self._store_cap // self.shards
            parts = [(k * per, (k + 1) * per,
                      self._host(p).view(np.uint32))
                     for k, p in enumerate(self._store_parts)]
        elif self.store is None:
            return []
        else:
            parts = [(0, int(self.store.shape[0]),
                      self._host(self.store).view(np.uint32))]
        _count("resident/absorb_d2h_bytes",
               sum(p[2].nbytes for p in parts))
        return parts

    def shard_digests(self, export):
        """Per-shard digest readback for the mesh's template absorb: for
        each store shard, this commit's digests read back from the slots
        the store scatter wrote there (no full digest matrix crosses
        shards). Returns [(global lane int32[k], uint32[k, 8]), ...] for
        IncrementalTrie's per-lane absorb; the readback is counted in
        resident/absorb_d2h_bytes."""
        lane_slot = np.asarray(export["lane_slot"], dtype=np.int64)
        lanes_all = np.arange(lane_slot.shape[0], dtype=np.int32)
        real = lane_slot >= 2  # pad lanes target the scratch slot 1
        per = self._store_cap // self.shards
        owner = np.minimum(lane_slot // per, self.shards - 1)
        parts, d2h = [], 0
        for k, store in enumerate(self._store_parts):
            sel = real & (owner == k)
            lanes_k = lanes_all[sel]
            if lanes_k.size == 0:
                parts.append((lanes_k, np.zeros((0, 8), np.uint32)))
                continue
            local = torch.from_numpy(lane_slot[sel] - k * per).to(
                store.device)
            with self._on_stream():
                digs = store.index_select(0, local).cpu().numpy()
            parts.append((lanes_k, digs.view(np.uint32)))
            d2h += lanes_k.size * 32
        self.last_absorb_d2h_bytes = d2h
        _count("resident/absorb_d2h_bytes", d2h)
        return parts

    def _note_collectives(self, export) -> None:
        """Per-commit mesh accounting for the flight record: the modeled
        (shards-1)/shards digest all-gather of a sharded commit
        (resident/gather_bytes_modeled) and its lanes per store shard; the
        measured gather is reset here and counted only by note_dig_gather.
        Unsharded commits record explicit zeros."""
        total_lanes = int(export["total_lanes"])
        n = self.shards
        self.last_gather_bytes = 0
        self.last_absorb_d2h_bytes = 0
        if n > 1:
            self.last_gather_bytes_modeled = total_lanes * 32 * (n - 1) // n
            per = max(1, self.store_capacity // n)
            owner = np.minimum(np.asarray(export["lane_slot"]) // per, n - 1)
            self.last_shard_lanes = np.bincount(owner, minlength=n).tolist()
        else:
            self.last_gather_bytes_modeled = 0
            self.last_shard_lanes = [total_lanes]
        _count("resident/gather_bytes_modeled",
               self.last_gather_bytes_modeled)

    def note_dig_gather(self, export) -> None:
        """A sharded commit's full digest matrix was read back to the host
        (the template absorb's full readback): count the measured
        cross-shard gather, (shards-1)/shards of every lane's digest."""
        n = self.shards
        if n <= 1:
            return
        self.last_gather_bytes = int(export["total_lanes"]) * 32 \
            * (n - 1) // n
        _count("resident/gather_bytes", self.last_gather_bytes)

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
        if self.shards > 1:
            return self._ensure_store_sharded(slots_needed)
        if self.store is None:
            self.store = self._zeros(max(2 * slots_needed, 4096), 8)
        elif self.store.shape[0] < slots_needed:
            cap = max(2 * slots_needed, 2 * self.store.shape[0])
            grown = self._zeros(cap, 8)
            grown[:self.store.shape[0]] = self.store
            self.store = grown

    def _ensure_arena(self, cls: int, rows_needed: int):
        if self.shards > 1:
            return self._ensure_arena_sharded(cls, rows_needed)
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

    # ---- sharded capacity: growth moves the block boundaries, so the
    # rows are gathered on the first device and split again ----

    def _split(self, full: torch.Tensor, extra: int) -> list:
        """Row blocks of `full` (a multiple of shards rows) on the shard
        devices, each with `extra` zero words appended flat."""
        per = full.shape[0] // self.shards
        parts = []
        for k, dev in enumerate(self.shard_devices):
            block = full[k * per:(k + 1) * per].reshape(-1).to(dev)
            if extra:
                block = torch.cat([block, block.new_zeros(extra)])
            parts.append(block)
        return parts

    def _ensure_store_sharded(self, slots_needed: int):
        if not self._store_parts:
            cap = self._cap(max(2 * slots_needed, 4096))
        elif self._store_cap < slots_needed:
            cap = self._cap(max(2 * slots_needed, 2 * self._store_cap))
        else:
            return
        full = self._zeros(cap, 8)
        if self._store_parts:
            full[:self._store_cap] = torch.cat(
                [p.to(self.device) for p in self._store_parts])
        self._store_parts = [p.view(-1, 8) for p in self._split(full, 0)]
        self._store_cap = cap

    def _part_rows(self, cls: int, k: int) -> torch.Tensor:
        """Shard k's row block of the class's arena (scratch excluded)."""
        width = cls * WORDS_PER_BLOCK
        per = self._rows[cls] // self.shards
        return self._flat_parts[cls][k][:per * width].view(per, width)

    def _ensure_arena_sharded(self, cls: int, rows_needed: int):
        rows = self._rows.get(cls)
        if rows is None:
            cap = self._cap(max(2 * rows_needed, 1024))
        elif rows < rows_needed:
            cap = self._cap(max(2 * rows_needed, 2 * rows))
        else:
            return
        full = self._zeros(cap, cls * WORDS_PER_BLOCK)
        if rows is not None:
            full[:rows] = torch.cat([self._part_rows(cls, k).to(self.device)
                                     for k in range(self.shards)])
        self._flat_parts[cls] = self._split(full, 1)  # + the scratch word
        self._rows[cls] = cap

    # ---- the device steps ----

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
        return torch.empty(n + n // 4, dtype=torch.int32, device="cpu",
                           pin_memory=self.device.type == "cuda")

    # ---- one commit ----

    def run(self, export) -> torch.Tensor:
        """Execute one resident commit on the executor's stream. `export`
        is the dict of native.mpt.IncrementalTrie.export_resident_plan().
        Returns the root digest as a lazy int32[8] on the device;
        root_bytes() reads it.

        Its host time is five phases in turn (the resident/phase/* timers,
        metrics.PhaseSeq): `stage` (the staging buffers packed, before
        the first event), `scatter` (the uploads and the fresh and lean
        rows into the arenas), then per segment `patch` and `hash`, each
        summed over the commit, and `store` (the store scatter and the
        last event)."""
        with self._on_stream(), PhaseSeq() as ph:
            if self.shards > 1:
                root = self._run_sharded(export, ph)
            else:
                root = self._run(export, ph)
        self._note_collectives(export)
        return root

    def _run(self, export, ph: PhaseSeq) -> torch.Tensor:
        ph.to("resident/phase/stage")
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

        ph.to("resident/phase/scatter")
        cuda = self.device.type == "cuda"
        t0 = self._event() if cuda else None
        rows_d = rows_t[:rp].to(self.device, non_blocking=True)
        aux_d = aux_t[:n_aux].to(self.device, non_blocking=True)
        t_up = self._event() if cuda else None
        self._ring.append((aux_t, rows_t, t_up))
        self.h2d_bytes = rp * 4 + n_aux * 4
        self.last_transfers = 2

        # the patch tables (off, src, oldidx) are aux_d's first 3 * len_off
        # words, which K3 reads in place
        p = 3 * len_off
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
        patched = 0
        for blocks, lanes, gstart, npatch, patch_off, lane_off in specs_t:
            if npatch:
                ph.to("resident/phase/patch")
                keccak_cuda.resident_patch(self._flat[blocks], self.store,
                                           dig, aux_d, len_off, patch_off,
                                           npatch)
                patched += 1
            ph.to("resident/phase/hash")
            self._hash_segment(blocks, lanes, gstart, dig,
                               rowidx_all[lane_off:lane_off + lanes])
        ph.to("resident/phase/store")
        # the store scatter runs last (the patches read the old digests);
        # pad lanes target the scratch slot 1, so the duplicate indices
        # there are harmless, and slot 0 is never written
        self.store.index_copy_(0, lane_slot.long(), dig[1:])
        if t0 is not None:
            self.last_events = (t0, t_up, self._event())
            self.last_done = self.last_events[2]
        self.last_patch_launches = patched if cuda else 0
        self.last_dig = dig
        self.last_root = dig[int(export["root_lane"]) + 1]
        return self.last_root

    def _run_sharded(self, export, ph: PhaseSeq) -> torch.Tensor:
        """One commit over the row shards (module docstring): host
        partitioning, two uploads, the up-front store gather, then per
        segment the strips beside dig, added on the parent row's shard,
        and K1 per shard; the store scatter last. The phases are _run's:
        the partitioning is `stage`, the store gather `scatter`."""
        ph.to("resident/phase/stage")
        specs = export["specs"]
        if len(specs) > MAX_SEGMENTS:
            raise ValueError(f"{len(specs)} segments > {MAX_SEGMENTS}")
        self._ensure_store(export["store_slots"])
        for cls, (_n_fresh, rows_needed) in export["classes"].items():
            self._ensure_arena(cls, rows_needed)
        lean = export.get("lean")
        if lean is not None and not lean[1].shape[0]:
            lean = None
        for cls in ({int(s_[0]) for s_ in specs} | set(export["fresh"])
                    | ({1} if lean is not None else set())):
            self._ensure_arena(cls, 1)  # segment-only classes must exist
        n, devs, home = self.shards, self.shard_devices, self.device
        per_s = self._store_cap // n
        per_r = {cls: rows // n for cls, rows in self._rows.items()}

        aux: list = []   # int32 pieces of the one index upload
        rows: list = []  # int32 pieces of the one row upload

        def put(buf: list, a) -> tuple:
            a = np.asarray(a)
            # u32 rows travel as their bits, indices as int32 values
            a = np.ascontiguousarray(
                a.view(np.int32) if a.dtype == np.uint32
                else a.astype(np.int32)).reshape(-1)
            start = sum(x.shape[0] for x in buf)
            buf.append(a)
            return start, a.shape[0]

        def owner(idx, per):
            return np.minimum(np.asarray(idx, np.int64) // per, n - 1)

        # fresh rows (and lean records) to the shard owning their row
        fresh_plan = []
        for cls in sorted(export["fresh"]):
            frows, fidx = export["fresh"][cls]
            own = owner(fidx, per_r[cls])
            for k in range(n):
                sel = np.nonzero(own == k)[0]
                if sel.size:
                    fresh_plan.append((cls, k, put(aux, fidx[sel] - k *
                                                   per_r[cls]),
                                       put(rows, frows[sel])))
        lean_plan = []
        if lean is not None:
            lrows, lidx, llen = lean
            own = owner(lidx, per_r[1])
            for k in range(n):
                sel = np.nonzero(own == k)[0]
                if sel.size:
                    lean_plan.append((k, put(aux, lidx[sel] - k * per_r[1]),
                                      put(aux, llen[sel]),
                                      put(rows, lrows[sel])))
        # every store slot a patch reads, gathered up front into `pre`
        src = np.asarray(export["src"], np.int64)
        oldidx = np.asarray(export["oldidx"], np.int64)
        clean = np.where(src < 0, -src, 0)
        reads = np.unique(np.concatenate([clean, oldidx, [0]]))
        own = owner(reads, per_s)
        gather_plan = []
        for k in range(n):
            sel = np.nonzero(own == k)[0]
            if sel.size:
                gather_plan.append((k, put(aux, sel),
                                    put(aux, reads[sel] - k * per_s)))
        off = np.asarray(export["off"], np.int64)
        p_off = put(aux, off)
        p_src = put(aux, src)
        p_new = put(aux, np.searchsorted(reads, clean))
        p_old = put(aux, np.searchsorted(reads, oldidx))
        # per segment and shard: the patches of the rows it owns (with
        # their word in the shard's block) and the lanes it hashes
        rowidx = export["rowidx"]
        seg_plan = []
        for blocks, lanes, gstart, npatch, patch_off, lane_off in (
                tuple(int(v) for v in s_) for s_ in specs):
            width = blocks * WORDS_PER_BLOCK
            span = per_r[blocks] * width
            word = off[patch_off:patch_off + npatch] >> 2
            pown = owner(word // width, per_r[blocks])
            lrow = rowidx[lane_off:lane_off + lanes]
            lown = owner(lrow, per_r[blocks])
            parts = []
            for k in range(n):
                ps = np.nonzero(pown == k)[0]
                ls = np.nonzero(lown == k)[0]
                parts.append((
                    put(aux, patch_off + ps) if ps.size else None,
                    put(aux, word[ps] - k * span) if ps.size else None,
                    put(aux, ls) if ls.size else None,
                    put(aux, lrow[ls] - k * per_r[blocks])
                    if ls.size else None))
            seg_plan.append((blocks, lanes, gstart, parts))
        # the store scatter: each lane's digest to its slot's owner
        lane_slot = np.asarray(export["lane_slot"], np.int64)
        own = owner(lane_slot, per_s)
        store_plan = []
        for k in range(n):
            sel = np.nonzero(own == k)[0]
            if sel.size:
                store_plan.append((k, put(aux, sel + 1),
                                   put(aux, lane_slot[sel] - k * per_s)))
        self.last_lean_rows = 0 if lean is None else int(lean[1].shape[0])
        self.last_lean_wire_bytes = self.last_lean_rows * (
            4 * LEAN_WORDS + 8)

        aux_h = np.concatenate(aux) if aux else np.zeros(0, np.int32)
        rows_h = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        ph.to("resident/phase/scatter")
        cuda = home.type == "cuda"
        t0 = self._event() if cuda else None
        aux_d = {home: torch.from_numpy(aux_h).to(home)}
        rows_d = {home: torch.from_numpy(rows_h).to(home)}
        t_up = self._event() if cuda else None
        for d in devs:  # the other distinct devices: device copies
            if d not in aux_d:
                aux_d[d] = aux_d[home].to(d)
                rows_d[d] = rows_d[home].to(d)
        self.h2d_bytes = aux_h.nbytes + rows_h.nbytes
        self.last_transfers = 2

        def tab(d, piece):
            start, length = piece
            return aux_d[d][start:start + length]

        for cls, k, p_idx, p_rows in fresh_plan:
            d = devs[k]
            width = cls * WORDS_PER_BLOCK
            start, length = p_rows
            block = rows_d[d][start:start + length].view(-1, width)
            self._part_rows(cls, k).index_copy_(0, tab(d, p_idx).long(),
                                                block)
        for k, p_idx, p_len, p_rows in lean_plan:
            d = devs[k]
            start, length = p_rows
            lrows = rows_d[d][start:start + length].view(-1, LEAN_WORDS)
            llen = tab(d, p_len).long()
            full = torch.zeros((lrows.shape[0], WORDS_PER_BLOCK),
                               dtype=torch.int32, device=d)
            full[:, :LEAN_WORDS] = lrows
            lane = torch.arange(lrows.shape[0], device=d)
            full.index_put_((lane, llen >> 2),
                            (1 << ((llen & 3) * 8)).to(torch.int32),
                            accumulate=True)
            full[:, WORDS_PER_BLOCK - 1] |= _SIGN_BIT
            self._part_rows(1, k).index_copy_(0, tab(d, p_idx).long(), full)

        pre = self._zeros(reads.shape[0], 8)
        for k, p_pos, p_local in gather_plan:
            d = devs[k]
            got = self._store_parts[k].index_select(0, tab(d, p_local).long())
            pre.index_copy_(0, tab(home, p_pos).long(), got.to(home))
        off_d, src_d = tab(home, p_off).long(), tab(home, p_src).long()
        new_d, old_d = tab(home, p_new).long(), tab(home, p_old).long()
        g_pad = _pow2_bucket(int(export["total_lanes"]))
        dig = self._zeros(1 + g_pad, 8)
        for blocks, lanes, gstart, parts in seg_plan:
            ph.to("resident/phase/patch")
            for k, (p_pat, p_word, p_lane, p_row) in enumerate(parts):
                if p_pat is None:
                    continue
                d = devs[k]
                pidx = tab(home, p_pat).long()
                s_src = src_d[pidx]
                # signed source: +k = this commit's dig row k, else the
                # gathered store digest (the zero slot 0 for none)
                new = torch.where(s_src[:, None] > 0,
                                  dig[s_src.clamp(min=0)], pre[new_d[pidx]])
                shift = off_d[pidx] & 3
                delta = to_int32((_strips(new, shift) - _strips(
                    pre[old_d[pidx]], shift)) & MASK32).to(d)
                flat = self._flat_parts[blocks][k]
                scratch = flat.shape[0] - 1
                idx = (tab(d, p_word).long()[:, None]
                       + torch.arange(9, dtype=torch.int64, device=d)
                       ).reshape(-1)
                idx = torch.where((idx >= 0) & (idx < scratch), idx,
                                  torch.full_like(idx, scratch))
                flat.index_add_(0, idx, delta.reshape(-1))
            ph.to("resident/phase/hash")
            for k, (p_pat, p_word, p_lane, p_row) in enumerate(parts):
                if p_lane is None:
                    continue
                d = devs[k]
                words = self._part_rows(blocks, k).index_select(
                    0, tab(d, p_row).long())
                out = self.seg_impl(words.view(-1, blocks, WORDS_PER_BLOCK))
                dig.index_copy_(0, gstart + 1 + tab(home, p_lane).long(),
                                out.to(home))
        ph.to("resident/phase/store")
        # the store scatter runs last (the patches read the old digests)
        for k, p_lane, p_local in store_plan:
            d = devs[k]
            vals = dig.index_select(0, tab(home, p_lane).long()).to(d)
            self._store_parts[k].index_copy_(0, tab(d, p_local).long(),
                                             vals)
        if cuda:
            cur = torch.cuda.current_stream(home)
            for s_ in self._peer_streams:
                cur.wait_stream(s_)
            self.last_events = (t0, t_up, self._event())
            self.last_done = self.last_events[2]
        self.last_dig = dig
        self.last_root = dig[int(export["root_lane"]) + 1]
        return self.last_root

    def root_bytes(self, root, done=None) -> bytes:
        """Synchronise and render a run() result (or a host array of 8
        words) as the 32-byte root, read on the executor's stream, once
        the event `done` (a pipelined commit's last, when given) has
        completed: the resident/phase/readback timer."""
        with phase_timer("resident/phase/readback"):
            if done is not None:
                done.synchronize()
            if isinstance(root, torch.Tensor):
                root = self._host(root)
            return np.ascontiguousarray(root).view(np.uint32).astype(
                "<u4").tobytes()
