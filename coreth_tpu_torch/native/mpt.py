"""ctypes bridge to the native MPT commit planners: the full-rebuild
planner (mpt.cpp, `plan_commit`) and the incremental trie (mpt_inc.cpp,
`IncrementalTrie`). Counterpart of coreth_tpu/native/mpt.py.

`plan_commit(items)` lays a sorted (key32 -> value) leaf set out natively
as the planned executor's word stream and patch tables; the plan runs on
the host (`CommitPlan.execute_cpu`, threaded keccak: the oracle) or through
ops/keccak_planned.PlannedCommit (`execute_planned`: kernel K1 on CUDA).

`IncrementalTrie` keeps a persistent native trie across commits and plans
only the dirty subtree each time. Its commits run on the host
(`commit_cpu`), through PlannedCommit with the digests read back into the
native cache (`commit_device`), or device-resident through
ops/keccak_resident.ResidentExecutor (`commit_resident`, `commit_template`,
`commit_resident_dispatch`), where digests and node rows stay on the card
from commit to commit.

Both libraries are built with g++ into coreth_tpu_torch/_build/ at first
use; a failed build raises. Not ported here: `CommitPlan.execute_device`
and `execute_staged` (the legacy fused and staged executors), the
per-shard template absorb, the "resident/before_absorb" failpoint
(ROADMAP "Still to port", items 7, 6 and 8), and the device watchdog with
its host takeover (`DeviceWedgedError`, `_run_with_watchdog`, the
`timeout=` arguments, `commit_resident_timed`, `rehash_host`), which only
the chain's resident mirror calls (ROADMAP item 4). The reference's phase timers
are plain attributes: `last_plan_ms`, `last_export_ms`,
`last_host_hash_ms` and `last_absorb_ms` of the last commit.

Reference seams: trie/hasher.go:195-201 (hashData), trie/trie.go:573-626
(Hash/Commit walk), core/state/statedb.go:952 (IntermediateRoot drain).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from . import CXX_FLAGS, default_cpu_threads  # noqa: F401  (one policy)
from ._build import build_and_load

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_lib = None
_inc_lib = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_P, _U64, _I64, _I32, _INT = (ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_int32, ctypes.c_int)


def _bind(lib, table) -> None:
    for name, restype, argtypes in table:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


_PLAN_API = [
    ("mpt_plan", _P, [_u8p, _u8p, _u64p, _U64]),
    ("mpt_plan_borrowed", _P, [_u8p, _u8p, _u64p, _U64]),
    ("mpt_plan_last_timings", None, [_f64p]),
    *[(name, _U64, [_P]) for name in (
        "mpt_plan_flat_bytes", "mpt_plan_total_lanes", "mpt_plan_num_segments",
        "mpt_plan_total_patches", "mpt_plan_num_hashed", "mpt_plan_num_nodes")],
    ("mpt_plan_root_pos", _I32, [_P]),
    ("mpt_plan_export", None, [_P, _u8p, _i32p, _i32p, _i32p, _i32p, _i32p]),
    # the digest pointer is c_void_p so execute_cpu may pass None
    ("mpt_plan_execute_cpu", None, [_P, _INT, _P, _u8p]),
    ("mpt_plan_msg_lens", None, [_P, _i32p]),
    ("mpt_plan_export_word_patches", None, [_P, _i32p, _i32p, _i32p]),
    ("mpt_plan_flat_ptr", ctypes.POINTER(ctypes.c_uint8), [_P]),
    ("mpt_plan_specs", None, [_P, _i32p]),
    ("mpt_plan_free", None, [_P]),
]

_INC_API = [
    ("mpt_inc_new", _P, [_u8p, _u8p, _u64p, _U64]),
    ("mpt_inc_update", _U64, [_P, _u8p, _u8p, _u64p, _U64]),
    *[(name, _U64, [_P]) for name in (
        "mpt_inc_plan", "mpt_inc_flat_bytes", "mpt_inc_num_nodes",
        "mpt_inc_num_dirty", "mpt_inc_total_lanes", "mpt_inc_total_patches",
        "mpt_inc_plan_res", "mpt_inc_rollback")],
    ("mpt_inc_root_pos", _I32, [_P]),
    ("mpt_inc_flat_ptr", ctypes.POINTER(ctypes.c_uint8), [_P]),
    ("mpt_inc_specs", None, [_P, _i32p]),
    ("mpt_inc_word_patches", None, [_P, _i32p, _i32p, _i32p]),
    ("mpt_inc_execute_cpu", None, [_P, _INT, _u8p]),
    ("mpt_inc_absorb", None, [_P, _u8p, _u8p]),
    ("mpt_inc_res_meta", None, [_P, _i64p]),
    ("mpt_inc_res_specs", None, [_P, _i32p]),
    ("mpt_inc_res_cls_counts", None, [_P, _i32p]),
    ("mpt_inc_res_fresh", None, [_P, _I32, _u8p, _i32p]),
    ("mpt_inc_res_tables", None, [_P, _i32p, _i32p, _i32p, _i32p, _i32p]),
    ("mpt_inc_res_absorb", None, [_P, _u8p, _u8p]),
    ("mpt_inc_res_absorb_lanes", _I64, [_P, _i32p, _u8p, _I64]),
    ("mpt_inc_res_absorb_finish", _I64, [_P, _u8p]),
    ("mpt_inc_set_lean", None, [_P, _I32]),
    ("mpt_inc_res_lean_count", _I64, [_P]),
    ("mpt_inc_res_lean", None, [_P, _u8p, _i32p, _i32p]),
    *[(name, None, [_P]) for name in (
        "mpt_inc_res_mark_clean", "mpt_inc_res_reset", "mpt_inc_checkpoint",
        "mpt_inc_discard_checkpoint", "mpt_inc_free")],
    ("mpt_inc_flush_oldest", None, [_P, _U64]),
    ("mpt_inc_root", None, [_P, _u8p]),
    ("mpt_inc_get", _I64, [_P, _u8p, _u8p, _I64]),
    ("mpt_inc_absorb_store", None, [_P, _u8p, _I64]),
    ("mpt_inc_absorb_store_range", None, [_P, _u8p, _I64, _I64]),
    ("mpt_inc_export_size", _I64, [_P, _i64p]),
    ("mpt_inc_export_nodes", None, [_P, _u8p, _u8p, _u64p]),
    ("mpt_inc_export_delta_size", _I64, [_P, _i64p]),
    ("mpt_inc_export_delta_nodes", None, [_P, _u8p, _u8p, _u64p]),
]


def _load(src: str, lib_name: str, table) -> ctypes.CDLL:
    lib = build_and_load(CXX_FLAGS, [os.path.join(_DIR, src)], lib_name,
                         link=["-lpthread"], timeout=600)
    _bind(lib, table)
    return lib


def load() -> ctypes.CDLL:
    """The full-rebuild planner (mpt.cpp), built at first use; raises when
    the build fails."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load("mpt.cpp", "libmpt.so", _PLAN_API)
    return _lib


def load_inc() -> ctypes.CDLL:
    """The incremental planner (mpt_inc.cpp), built at first use; raises
    when the build fails."""
    global _inc_lib
    if _inc_lib is None:
        with _lock:
            if _inc_lib is None:
                _inc_lib = _load("mpt_inc.cpp", "libmpt_inc.so", _INC_API)
    return _inc_lib


def _specs(rows: np.ndarray):
    from ..ops.keccak_fused import SegmentSpec

    return tuple(SegmentSpec(int(a), int(b), int(c), int(d))
                 for a, b, c, d in rows)


class CommitPlan:
    """A planned trie commit: native layout, host or device execution."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self.num_hashed = int(lib.mpt_plan_num_hashed(handle))
        self.num_nodes = int(lib.mpt_plan_num_nodes(handle))
        self.total_lanes = int(lib.mpt_plan_total_lanes(handle))
        self.root_pos = int(lib.mpt_plan_root_pos(handle))
        self._exported = None
        self._exported_words = None

    def __del__(self):
        h, self._h = self._h, None
        if h:
            self._lib.mpt_plan_free(h)

    def export(self):
        """(specs, flat_msgs u8, nblocks i32[total_lanes], patch_lane,
        patch_off, patch_child): the byte-space layout of the legacy fused
        executor (ROADMAP "Still to port", item 7), kept for parity checks."""
        if self._exported is not None:
            return self._exported
        lib, h = self._lib, self._h
        n_seg = int(lib.mpt_plan_num_segments(h))
        flat = np.empty(int(lib.mpt_plan_flat_bytes(h)), dtype=np.uint8)
        nblocks = np.empty(self.total_lanes, dtype=np.int32)
        n_pat = int(lib.mpt_plan_total_patches(h))
        pl = np.empty(n_pat, dtype=np.int32)
        po = np.empty(n_pat, dtype=np.int32)
        pc = np.empty(n_pat, dtype=np.int32)
        specs = np.empty((n_seg, 4), dtype=np.int32)
        lib.mpt_plan_export(h, flat, nblocks, pl, po, pc, specs.reshape(-1))
        self._exported = (_specs(specs), flat, nblocks, pl, po, pc)
        return self._exported

    def export_words(self):
        """The planned executor's layout (ops/keccak_planned.py): (specs,
        flat_words u32[total_words], dst_word i32[P], child_lane i32[P],
        shift i32[P]), the flat bytes read as little-endian words and the
        patches in word space. flat_words is a zero-copy view into the
        plan's native buffer, valid while this CommitPlan is alive."""
        if self._exported_words is not None:
            return self._exported_words
        lib, h = self._lib, self._h
        n_bytes = int(lib.mpt_plan_flat_bytes(h))
        flat = np.ctypeslib.as_array(lib.mpt_plan_flat_ptr(h),
                                     shape=(n_bytes,))
        n_seg = int(lib.mpt_plan_num_segments(h))
        specs = np.empty((n_seg, 4), dtype=np.int32)
        lib.mpt_plan_specs(h, specs.reshape(-1))
        n_pat = int(lib.mpt_plan_total_patches(h))
        dst_word = np.empty(n_pat, dtype=np.int32)
        child_lane = np.empty(n_pat, dtype=np.int32)
        shift = np.empty(n_pat, dtype=np.int32)
        lib.mpt_plan_export_word_patches(h, dst_word, child_lane, shift)
        self._exported_words = (_specs(specs), flat.view(np.uint32),
                                dst_word, child_lane, shift)
        return self._exported_words

    def execute_planned(self, planned=None, device=None) -> bytes:
        """Run the plan through a PlannedCommit (`planned`, else the default
        one of `device`: None is CUDA, kernel K1); returns the 32-byte
        root."""
        if planned is None:
            from ..ops.keccak_planned import default_planned_commit

            planned = default_planned_commit(device)
        specs, flat_words, dst_word, child_lane, shift = self.export_words()
        root, _ = planned.run(specs, flat_words, dst_word, child_lane, shift,
                              self.root_pos)
        return root

    def execute_cpu(self, threads: int = 1) -> bytes:
        """Host execution (threaded keccak); returns the 32-byte root."""
        root = np.empty(32, dtype=np.uint8)
        self._lib.mpt_plan_execute_cpu(self._h, threads, None, root)
        return root.tobytes()

    def execute_cpu_digests(self, threads: int = 1):
        """Host execution returning (root32, dig uint8[total_lanes, 32],
        real_mask bool[total_lanes]): the per-lane oracle for device parity
        checks (pad lanes are left zero and masked out)."""
        dig = np.zeros((self.total_lanes, 32), dtype=np.uint8)
        root = np.empty(32, dtype=np.uint8)
        self._lib.mpt_plan_execute_cpu(self._h, threads, dig.ctypes.data,
                                       root)
        msg_len = np.empty(self.total_lanes, dtype=np.int32)
        self._lib.mpt_plan_msg_lens(self._h, msg_len)
        return root.tobytes(), dig, msg_len > 0


def plan_commit(keys: np.ndarray, vals_blob: bytes,
                val_offsets: np.ndarray) -> CommitPlan:
    """keys: uint8[n, 32] sorted unique; vals_blob the concatenated values
    with val_offsets uint64[n+1]."""
    lib = load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8).reshape(-1)
    n = keys.shape[0] // 32
    if n == 0:
        raise ValueError("empty leaf set: commit of an empty trie is EMPTY_ROOT")
    blob = np.frombuffer(vals_blob, dtype=np.uint8)
    if blob.size == 0:
        blob = np.zeros(1, dtype=np.uint8)
    blob = np.ascontiguousarray(blob)
    off = np.ascontiguousarray(val_offsets, dtype=np.uint64)
    # zero-copy: the native side reads the arrays only during this call
    h = lib.mpt_plan_borrowed(keys, blob, off, n)
    if not h:
        raise ValueError("mpt_plan rejected input (unsorted or duplicate keys)")
    return CommitPlan(h, lib)


def items_to_arrays(items: Sequence[Tuple[bytes, bytes]]):
    """(key32, value) pairs -> the planner's sorted array triple (keys
    u8[n, 32], vals_blob, offsets u64[n+1]); a duplicate key resolves
    last-write-wins."""
    dedup = {}
    for k, v in items:
        dedup[k] = v
    items = sorted(dedup.items())
    n = len(items)
    if n == 0:
        raise ValueError("empty leaf set: commit of an empty trie is EMPTY_ROOT")
    keys = np.frombuffer(b"".join(k for k, _ in items),
                         dtype=np.uint8).reshape(n, 32)
    vals = b"".join(v for _, v in items)
    off = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(np.fromiter((len(v) for _, v in items), np.uint64, count=n),
              out=off[1:])
    return keys, vals, off


def plan_from_items(items: Sequence[Tuple[bytes, bytes]]) -> CommitPlan:
    """plan_commit over items_to_arrays(items)."""
    return plan_commit(*items_to_arrays(items))


EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)

# Lean wire record width (native kLeanWidth): a fresh class-1 row whose RLP
# fits this many bytes ships content-only and the device re-derives the
# keccak pad bits, so a leaf costs 72 B of row payload + 4 B arena index +
# 4 B length on the wire instead of the 136 B padded row.
LEAN_ROW_WIDTH = 72


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


class IncrementalTrie:
    """Persistent native MPT with per-commit dirty-subtree planning: the
    warm trie plus dirty-only re-hash of the reference (trie/trie.go:
    573-626 with triedb/hashdb). The tree and its digest cache live across
    commits; each commit plans and hashes only the dirty subtree.

    A trie commits in one mode, pinned by its first commit: "host"
    (commit_cpu, commit_device: the digest cache on the host), "resident"
    (commit_resident*: digests only in the executor's device store) or
    "template" (commit_template: device store plus the host cache). Mixing
    modes would serve stale digests, so a commit in another mode raises."""

    def __init__(self, items: Sequence[Tuple[bytes, bytes]] = ()):
        lib = load_inc()
        self._lib = lib
        self._mode: Optional[str] = None
        self.last_plan_ms = 0.0
        self.last_export_ms = 0.0
        self.last_host_hash_ms = 0.0
        self.last_absorb_ms = 0.0
        keys, vals, off = items_to_arrays(items) if items else (
            np.zeros((0, 32), np.uint8), b"", np.zeros(1, np.uint64))
        blob = (np.frombuffer(vals, dtype=np.uint8) if vals
                else np.zeros(1, np.uint8))
        self._h = lib.mpt_inc_new(
            np.ascontiguousarray(keys.reshape(-1)),
            np.ascontiguousarray(blob),
            np.ascontiguousarray(off, dtype=np.uint64),
            keys.shape[0],
        )
        if not self._h:
            raise ValueError("unsorted or duplicate keys")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mpt_inc_free(h)

    def update(self, items: Sequence[Tuple[bytes, bytes]]) -> int:
        """Apply (key32, value) updates; an empty value deletes. Returns the
        number of keys that changed the trie."""
        n = len(items)
        if n == 0:
            return 0
        keys = np.frombuffer(b"".join(k for k, _ in items), np.uint8)
        vals = b"".join(v for _, v in items)
        blob = np.frombuffer(vals, np.uint8) if vals else np.zeros(1, np.uint8)
        off = np.zeros(n + 1, np.uint64)
        np.cumsum(np.fromiter((len(v) for _, v in items), np.uint64, count=n),
                  out=off[1:])
        return int(self._lib.mpt_inc_update(
            self._h, np.ascontiguousarray(keys), np.ascontiguousarray(blob),
            off, n))

    @property
    def num_nodes(self) -> int:
        return int(self._lib.mpt_inc_num_nodes(self._h))

    def _export_plan(self):
        lib, h = self._lib, self._h
        t0 = time.perf_counter()
        n_seg = int(lib.mpt_inc_plan(h))
        self.last_plan_ms = _ms_since(t0)
        if n_seg == 0:
            return None
        t0 = time.perf_counter()
        specs = np.empty((n_seg, 4), np.int32)
        lib.mpt_inc_specs(h, specs.reshape(-1))
        n_bytes = int(lib.mpt_inc_flat_bytes(h))
        flat_words = np.ctypeslib.as_array(
            lib.mpt_inc_flat_ptr(h), shape=(n_bytes,)).view(np.uint32)
        n_pat = int(lib.mpt_inc_total_patches(h))
        dst = np.empty(n_pat, np.int32)
        child = np.empty(n_pat, np.int32)
        shift = np.empty(n_pat, np.int32)
        lib.mpt_inc_word_patches(h, dst, child, shift)
        self.last_export_ms = _ms_since(t0)
        return (_specs(specs), flat_words, dst, child, shift,
                int(lib.mpt_inc_root_pos(h)))

    def commit_cpu(self, threads: int = 1) -> bytes:
        """Incremental host commit; returns the 32-byte root."""
        self._pin_mode("host")
        t0 = time.perf_counter()
        n_seg = self._lib.mpt_inc_plan(self._h)
        self.last_plan_ms = _ms_since(t0)
        if n_seg == 0:
            return self.root()
        out = np.empty(32, np.uint8)
        t0 = time.perf_counter()
        self._lib.mpt_inc_execute_cpu(self._h, threads, out)
        self.last_host_hash_ms = _ms_since(t0)
        return out.tobytes()

    def commit_device(self, planned=None, device=None) -> bytes:
        """Incremental commit through a PlannedCommit (`planned`, else the
        default one of `device`: None is CUDA, kernel K1): the upload is
        the dirty set, the digests come back into the native cache."""
        self._pin_mode("host")
        exported = self._export_plan()
        if exported is None:
            return self.root()
        specs, flat_words, dst, child, shift, root_pos = exported
        if planned is None:
            from ..ops.keccak_planned import default_planned_commit

            planned = default_planned_commit(device)
        _root, dig = planned.run(specs, flat_words, dst, child, shift,
                                 root_pos, want_digests=True)
        dig8 = np.ascontiguousarray(dig).view(np.uint8).reshape(-1)
        out = np.empty(32, np.uint8)
        t0 = time.perf_counter()
        self._lib.mpt_inc_absorb(self._h, dig8, out)
        self.last_absorb_ms = _ms_since(t0)
        return out.tobytes()

    # ---- resident commits (deferred absorb + template residency) ----

    def _check_mode(self, mode: str):
        if self._mode is not None and self._mode != mode:
            raise RuntimeError(
                f"trie is in {self._mode!r} commit mode; {mode!r} commits "
                "would read a stale digest cache")

    def _pin_mode(self, mode: str):
        self._check_mode(mode)
        self._mode = mode

    def export_resident_plan(self):
        """Plan the dirty subtree for a device-resident commit and export
        the upload payload (ops/keccak_resident.ResidentExecutor.run's
        input). Returns None when nothing is dirty."""
        lib, h = self._lib, self._h
        t0 = time.perf_counter()
        n_seg = int(lib.mpt_inc_plan_res(h))
        self.last_plan_ms = _ms_since(t0)
        if n_seg == (1 << 64) - 1:
            raise ValueError("node RLP wider than the resident row limit")
        if n_seg == (1 << 64) - 2:
            raise ValueError(
                "resident arena class would exceed the 2GB byte-offset "
                "range (checked before any allocation)")
        if n_seg == 0:
            return None
        t0 = time.perf_counter()
        meta = np.empty(7, np.int64)
        lib.mpt_inc_res_meta(h, meta)
        total_lanes, total_patches = int(meta[0]), int(meta[1])
        specs = np.empty((n_seg, 6), np.int32)
        lib.mpt_inc_res_specs(h, specs.reshape(-1))
        n_cls = int(meta[6])
        cls_counts = np.empty((n_cls, 2), np.int32)
        lib.mpt_inc_res_cls_counts(h, cls_counts.reshape(-1))
        rowidx = np.empty(total_lanes, np.int32)
        lane_slot = np.empty(total_lanes, np.int32)
        off = np.empty(total_patches, np.int32)
        src = np.empty(total_patches, np.int32)
        oldidx = np.empty(total_patches, np.int32)
        lib.mpt_inc_res_tables(h, rowidx, lane_slot, off, src, oldidx)
        fresh = {}
        classes = {}
        for cls in range(1, n_cls):
            n_fresh, rows_needed = (int(cls_counts[cls, 0]),
                                    int(cls_counts[cls, 1]))
            if rows_needed > 1:
                classes[cls] = (n_fresh, rows_needed)
            if n_fresh == 0:
                continue
            width = cls * 136
            rows = np.empty(n_fresh * width, np.uint8)
            idx = np.empty(n_fresh, np.int32)
            lib.mpt_inc_res_fresh(h, cls, rows, idx)
            fresh[cls] = (rows.view(np.uint32).reshape(n_fresh, width // 4),
                          idx)
        lean = None
        n_lean = int(lib.mpt_inc_res_lean_count(h))
        if n_lean:
            lrows = np.empty(n_lean * LEAN_ROW_WIDTH, np.uint8)
            lidx = np.empty(n_lean, np.int32)
            llen = np.empty(n_lean, np.int32)
            lib.mpt_inc_res_lean(h, lrows, lidx, llen)
            lean = (lrows.view(np.uint32).reshape(n_lean,
                                                  LEAN_ROW_WIDTH // 4),
                    lidx, llen)
        self.last_export_ms = _ms_since(t0)
        return {
            "specs": specs,
            "classes": classes,
            "fresh": fresh,
            "lean": lean,
            "rowidx": rowidx,
            "lane_slot": lane_slot,
            "off": off,
            "src": src,
            "oldidx": oldidx,
            "total_lanes": total_lanes,
            "store_slots": int(meta[2]),
            "root_lane": int(meta[3]),
            "num_dirty": int(meta[4]),
            "fresh_bytes": int(meta[5]),
        }

    def _resident_export(self, executor, mode: str):
        """Plan and export, then pin `mode` and bind the executor: the
        export may raise before anything is pinned."""
        self._check_mode(mode)
        executor.check_binding(self)
        export = self.export_resident_plan()
        self._pin_mode(mode)
        executor.bind(self)
        return export

    def rebase_residency(self) -> None:
        """Abandon every device-side assignment (store slots, arena rows),
        mark the whole trie dirty and unpin the mode: the next resident or
        template commit re-uploads every row, as the first commit after
        construction does, so residency can rebuild on a fresh executor."""
        self._lib.mpt_inc_res_reset(self._h)
        self._mode = None

    def commit_resident(self, executor):
        """Device-resident commit: plan, ship fresh rows and patch tables,
        run, mark clean. Returns the lazy int32[8] root on the executor's
        device (executor.root_bytes(...) synchronises), so the caller can
        plan the next commit while this one runs."""
        if self.num_nodes == 0:
            # empty trie: nothing on the device, and the previous last_root
            # is stale; the root is the constant
            self._pin_mode("resident")
            executor.bind(self)
            empty = np.frombuffer(EMPTY_ROOT, np.uint8).view("<u4").copy()
            executor.last_root = empty
            return empty
        export = self._resident_export(executor, "resident")
        if export is None:
            return executor.last_root
        root = executor.run(export)
        self._lib.mpt_inc_res_mark_clean(self._h)
        return root

    def commit_resident_dispatch(self, executor):
        """Pipelined resident commit: plan and queue the device work
        without waiting for it, and return a resolve() closure that
        synchronises the root later. Between dispatch and resolve the
        caller may plan and dispatch further commits on the same executor;
        their patch tables read this commit's store on the same stream, so
        they run after it (executor.pipeline_depth bounds the staging
        buffers in flight). Every native-trie mutation happens before
        return; resolve() touches only the executor."""
        if self.num_nodes == 0:
            root = executor.root_bytes(self.commit_resident(executor))
            return lambda: root
        export = self._resident_export(executor, "resident")
        if export is None:
            handle = executor.last_root
        else:
            handle = executor.run(export)
            self._lib.mpt_inc_res_mark_clean(self._h)
        return lambda: executor.root_bytes(handle)

    def commit_template(self, executor):
        """Template-resident commit: the executor keeps this trie's row
        arenas and digest store across commits (uploads carry only fresh
        content), and the commit's digest matrix is read back and absorbed
        into the host cache, so root() and export_nodes() stay valid. Pins
        its own "template" mode. The whole matrix comes back in one
        readback; the reference's per-shard absorb waits for multi-GPU
        (ROADMAP "Still to port", item 6)."""
        if self.num_nodes == 0:
            self._pin_mode("template")
            executor.bind(self)
            return EMPTY_ROOT
        export = self._resident_export(executor, "template")
        if export is None:
            return self.root()
        executor.run(export)
        dig = executor.host_digests()
        # strip the zero-sentinel row: the native absorb takes global lane
        # order, as the planned path's digest matrix
        dig8 = np.ascontiguousarray(dig[1:]).view(np.uint8).reshape(-1)
        out = np.empty(32, np.uint8)
        t0 = time.perf_counter()
        self._lib.mpt_inc_res_absorb(self._h, dig8, out)
        self.last_absorb_ms = _ms_since(t0)
        if int(export["root_lane"]) < 0:
            return self.root()  # the root is not among this plan's lanes
        return out.tobytes()

    # ---- checkpoint / rollback (core/blockchain.go:1424 reorg,
    # plugin/evm/block.go:173 reject) ----

    def checkpoint(self) -> None:
        """Open an undo scope: updates until discard_checkpoint() or
        rollback() journal their previous state."""
        self._lib.mpt_inc_checkpoint(self._h)

    def discard_checkpoint(self) -> None:
        """Keep the scope's changes (block accepted); a nested scope merges
        into its parent."""
        self._lib.mpt_inc_discard_checkpoint(self._h)

    def rollback(self) -> int:
        """Revert every update since the last checkpoint (block rejected);
        returns the number of operations reverted. Reverted paths stay
        dirty, so the next commit re-plans them."""
        return int(self._lib.mpt_inc_rollback(self._h))

    def flush_oldest_checkpoints(self, k: int) -> None:
        """Drop the oldest `k` scopes, keeping their changes and freeing
        their journal."""
        if k > 0:
            self._lib.mpt_inc_flush_oldest(self._h, k)

    def dirty_stats(self):
        """(dirty hashed nodes, mini-plan bytes) of the current plan."""
        return (int(self._lib.mpt_inc_num_dirty(self._h)),
                int(self._lib.mpt_inc_flat_bytes(self._h)))

    # ---- state reads and persistence export (trie/trie.go:87 Get,
    # core/state_manager.go:153 interval Commit) ----

    def get(self, key: bytes) -> Optional[bytes]:
        """Value by 32-byte key; None when absent."""
        if len(key) != 32:
            raise ValueError("keys are 32 bytes (keccak-hashed)")
        k = np.frombuffer(key, np.uint8)
        out = np.empty(128, np.uint8)
        n = int(self._lib.mpt_inc_get(self._h, k, out, out.shape[0]))
        if n < 0:
            return None
        if n > out.shape[0]:
            out = np.empty(n, np.uint8)
            n = int(self._lib.mpt_inc_get(self._h, k, out, out.shape[0]))
        return out[:n].tobytes()

    def absorb_store(self, store) -> None:
        """Pull the executor's digest store (int32 or uint32 [S, 8], a torch
        tensor or an array) into the native digest cache: the sync point
        before export_nodes() on a resident-committed trie."""
        arr = _host_u8(store)
        self._lib.mpt_inc_absorb_store(self._h, arr, arr.size // 32)

    def absorb_store_parts(self, parts) -> None:
        """absorb_store over [(slot_lo, slot_hi, [rows, 8]), ...] as
        executor.store_parts() returns them."""
        for lo, hi, part in parts:
            self._lib.mpt_inc_absorb_store_range(
                self._h, _host_u8(part), int(lo), int(hi))

    def set_lean(self, on: bool) -> None:
        """Ship fresh class-1 rows whose RLP fits LEAN_ROW_WIDTH bytes as
        content-only records (the device re-derives the keccak padding).
        Safe to flip between commits."""
        self._lib.mpt_inc_set_lean(self._h, 1 if on else 0)

    def export_nodes(self, delta: bool = False):
        """Hashed nodes as (digests uint8[N, 32], rlp bytes, off
        uint64[N+1]) for the interval disk flush. The trie must be clean;
        a resident trie needs absorb_store first. delta=True exports only
        the nodes re-hashed since the previous export."""
        sz = np.empty(1, np.int64)
        size_fn = (self._lib.mpt_inc_export_delta_size if delta
                   else self._lib.mpt_inc_export_size)
        n = int(size_fn(self._h, sz))
        if n < 0:
            raise RuntimeError("trie has uncommitted changes; commit first")
        digests = np.empty((n, 32), np.uint8)
        rlp_buf = np.empty(max(int(sz[0]), 1), np.uint8)
        off = np.empty(n + 1, np.uint64)
        export_fn = (self._lib.mpt_inc_export_delta_nodes if delta
                     else self._lib.mpt_inc_export_nodes)
        export_fn(self._h, digests.reshape(-1), rlp_buf, off)
        return digests, rlp_buf[:int(sz[0])].tobytes(), off

    def root(self) -> bytes:
        if self.num_nodes == 0:
            return EMPTY_ROOT
        if self._mode == "resident":
            # resident commits never write the host digest cache
            raise RuntimeError(
                "trie is in resident mode: read the root from the "
                "executor handle returned by commit_resident()")
        out = np.empty(32, np.uint8)
        self._lib.mpt_inc_root(self._h, out)
        return out.tobytes()


def _host_u8(a) -> np.ndarray:
    """A torch tensor or array of digest words -> contiguous host bytes."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(-1)
