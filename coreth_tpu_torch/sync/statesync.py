"""EVM state sync (role of coreth sync/statesync/
{state_syncer,trie_sync_tasks,trie_segments,code_syncer}.go); counterpart
of coreth_tpu/sync/statesync.py.

Downloads tries as range-proofed leaf batches; each synced account
schedules its storage trie and code hash.

Small tries stream through a single StackTrie whose completed subtrees
persist as they hash (O(1) memory, one request for the common case).

Large tries (first response full with more remaining) switch to
SEGMENTED sync — the capability of trie_segments.go:65-417, keyspace
parallelism as the sync-time analog of sequence parallelism:

  * the 256-bit keyspace splits into NUM_SEGMENTS ranges fetched
    CONCURRENTLY, each an independent range-proofed stream
  * every segment persists a resume marker (sync_segment_key) in the
    same batch as the leaf data it points past, so an interrupted sync
    resumes each segment where it stopped — markered data is always on
    disk, unmarkered work is refetched (schema.go:108-114 semantics)
  * leaves land in an on-disk buffer (plus the flat snapshot); when all
    segments finish, ONE StackTrie rebuild over the ordered buffer
    reconstructs and persists the trie nodes and must reproduce the
    target root bit-exactly (stronger than the reference's per-segment
    stitching: the final root check covers the whole keyspace even
    across resumes). The rebuild is idempotent — a crash during it
    replays from the still-markered buffer.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..core import rawdb
from ..fault import failpoint
from ..fault import register as _register_failpoint
from ..metrics import count_drop, default_registry
from ..native import keccak256
from ..peer.network import FAIL_PROOF
from ..state.account import Account
from ..state.snapshot import account_snapshot_key, storage_snapshot_key
from ..state.statedb import _account_to_slim
from ..trie.node import EMPTY_ROOT
from ..trie.stacktrie import StackTrie
from .client import ClientError, RootUnavailableError, SyncClient

EMPTY_CODE_HASH = keccak256(b"")

FP_BEFORE_PIVOT = _register_failpoint(
    "sync/before_pivot",
    "before an in-flight sync re-targets to a newer summary root")
FP_BEFORE_REBUILD = _register_failpoint(
    "sync/before_rebuild",
    "before the terminal full-keyspace StackTrie rebuild of a "
    "segmented sync")

NUM_SEGMENTS = 4          # trie_segments.go numSegments split
SEGMENT_THRESHOLD = 2048  # leaves before a trie is considered "large"
DEFAULT_LEAF_LIMIT = 1024

# progress markers (core/rawdb/schema.go sync_storage/sync_segments)
SYNC_SEGMENT_PREFIX = b"sync_segments"
SYNC_STORAGE_PREFIX = b"sync_storage"
# temporary raw-leaf buffer for segmented rebuilds (deleted after the
# StackTrie pass verifies the root)
SYNC_LEAF_PREFIX = b"sync_leafbuf"

# segment marker values: b"D" done, b"S" + next_start in progress
_SEG_DONE = b"D"


def sync_segment_key(root: bytes, start: bytes) -> bytes:
    return SYNC_SEGMENT_PREFIX + root + start


def sync_storage_key(root: bytes, account_hash: bytes) -> bytes:
    return SYNC_STORAGE_PREFIX + root + account_hash


def sync_leaf_key(root: bytes, leaf_key: bytes) -> bytes:
    return SYNC_LEAF_PREFIX + root + leaf_key


class StateSyncError(Exception):
    pass


def _segment_bounds(n: int) -> List[bytes]:
    """Split the 32-byte keyspace into n equal starts."""
    step = (1 << 256) // n
    return [(i * step).to_bytes(32, "big") for i in range(n)]


class StateSyncer:
    """state_syncer.go:64-255 orchestration."""

    def __init__(self, client: SyncClient, diskdb, root: bytes,
                 num_threads: int = 4, leaf_limit: int = DEFAULT_LEAF_LIMIT,
                 segment_threshold: int = SEGMENT_THRESHOLD,
                 drain_confirm: bool = True,
                 note_event: Optional[Callable] = None):
        self.client = client
        self.diskdb = diskdb
        self.root = root
        self.leaf_limit = leaf_limit
        self.segment_threshold = segment_threshold
        self.num_threads = num_threads
        self.drain_confirm = drain_confirm
        self.pool: Optional[ThreadPoolExecutor] = None  # lazy; see close()
        self.lock = threading.Lock()
        self.code_hashes: Set[bytes] = set()
        self.storage_tasks: List = []  # (account_hash, storage_root)
        self.synced_storage_roots: Set[bytes] = set()
        self.pivots: List[Tuple[bytes, bytes]] = []  # (old_root, new_root)
        self.phase = "idle"
        self._note_event = note_event

    def _note(self, kind: str, **fields) -> None:
        """Flight-recorder hook (wired by syncervm); never lets an
        observer fault break the sync."""
        if self._note_event is None:
            return
        try:
            self._note_event(kind, **fields)
        except Exception:
            count_drop("sync/drops/note_event_error")

    def _workers(self) -> ThreadPoolExecutor:
        with self.lock:
            if self.pool is None:
                # bounded: num_threads caps concurrent storage-trie
                # fetches
                self.pool = ThreadPoolExecutor(max_workers=self.num_threads)
            return self.pool

    def close(self) -> None:
        """Release the worker pool (the pre-fix leak: threads outlived
        the sync). Safe to call repeatedly; a later sync()/pivot() lazily
        re-creates the pool."""
        with self.lock:
            pool, self.pool = self.pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "StateSyncer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- trie leaf streaming ---------------------------------------------

    def _sync_trie(self, root: bytes, on_leaf, account: bytes = b"",
                   on_unleaf=None) -> int:
        """Fetch one trie's leaves, persisting rebuilt nodes; returns the
        leaf count. Small tries stream through one StackTrie; large tries
        (>= segment_threshold leaves with more coming) switch to
        concurrent segments. on_unleaf(key, batch) undoes on_leaf's
        key-addressed side effects — used when discarding unverified
        buffered leaves (lying-peer recovery) so phantom snapshot entries
        cannot outlive the data that created them."""
        if root == EMPTY_ROOT:
            return 0

        # a previously-interrupted SEGMENTED sync resumes segmented
        seg_starts = _segment_bounds(NUM_SEGMENTS)
        if any(self.diskdb.get(sync_segment_key(root, s)) is not None
               for s in seg_starts):
            return self._sync_trie_segmented(root, on_leaf, on_unleaf)

        batch = self.diskdb.new_batch()

        def write_node(path: bytes, node_hash: bytes, blob: bytes) -> None:
            batch.put(node_hash, blob)

        st = StackTrie(write_fn=write_node)
        count = 0
        start = b""
        # resume from a previous partial UNSEGMENTED sync
        marker = self.diskdb.get(sync_storage_key(root, account))
        resumed = marker is not None
        if marker:
            start = marker
        # pre-switch leaves held in MEMORY (bounded by segment_threshold):
        # small tries — the overwhelmingly common case — never touch the
        # disk buffer; the leaves flush into it only at the actual switch
        pre_switch: List = [] if not resumed else None
        while True:
            resp = self.client.get_leafs(root, start=start, limit=self.leaf_limit)
            for k, v in zip(resp.keys, resp.vals):
                st.update(k, v)
                on_leaf(k, v, batch)
                if pre_switch is not None:
                    pre_switch.append((k, v))
                count += 1
            if not resp.more or not resp.keys:
                break
            if pre_switch is not None and count >= self.segment_threshold:
                # the trie IS large (>= threshold leaves and more coming):
                # buffer everything fetched so far + mark segment coverage
                # in one atomic batch, then go concurrent. Resumed
                # pre-switch syncs never take this path (their early
                # leaves were never retained). Stray buffer entries from a
                # crashed older sync of this root are cleared (with their
                # snapshot side effects) before the fresh seed.
                self._clear_leaf_buffer(root, on_unleaf)
                batch.delete(sync_storage_key(root, account))
                self._seed_segments(root, pre_switch, seg_starts, batch)
                return self._sync_trie_segmented(root, on_leaf, on_unleaf)
            start = _next_key(resp.keys[-1])
            # Commit the progress marker IN THE SAME batch as the leaf data it
            # points past (trie_sync_tasks.go batch+marker commit): a crash can
            # then only lose un-markered work, never markered-but-unwritten data.
            batch.put(sync_storage_key(root, account), start)
            batch.write()
            batch = self.diskdb.new_batch()
        got = st.hash()
        if not resumed and count > 0 and got != root:
            # a full-range rebuild must reproduce the root exactly; resumed
            # syncs only get per-batch range proofs (the final root check
            # happens at block verification)
            raise StateSyncError(
                f"rebuilt root mismatch: want {root.hex()[:12]} got {got.hex()[:12]}"
            )
        batch.delete(sync_storage_key(root, account))
        batch.write()
        return count

    # --- segmented path (trie_segments.go:65-417 capability) ---------------

    def _seed_segments(self, root: bytes, pre_switch, seg_starts,
                       batch) -> None:
        """Flush the single-stream prefix into the disk buffer and mark
        every segment done/in-progress/virgin relative to its last key —
        one atomic batch, so the switch either fully happens or the
        unsegmented marker path resumes as if it never did."""
        for k, v in pre_switch:
            batch.put(sync_leaf_key(root, k), v)
        last_key = pre_switch[-1][0]
        nxt = _next_key(last_key)
        ends = _segment_ends(seg_starts)
        for i, s in enumerate(seg_starts):
            if ends[i] <= last_key:
                batch.put(sync_segment_key(root, s), _SEG_DONE)
            elif s <= last_key:
                batch.put(sync_segment_key(root, s), b"S" + nxt)
            else:
                batch.put(sync_segment_key(root, s), b"S" + s)
        batch.write()

    def _sync_trie_segmented(self, root: bytes, on_leaf, on_unleaf=None) -> int:
        seg_starts = _segment_bounds(NUM_SEGMENTS)
        ends = _segment_ends(seg_starts)
        with ThreadPoolExecutor(max_workers=NUM_SEGMENTS) as seg_pool:
            futures = [
                seg_pool.submit(self._fetch_segment, root, on_leaf, s, e)
                for s, e in zip(seg_starts, ends)
            ]
            fetched = sum(f.result() for f in futures)
        count = self._rebuild_from_buffer(root, seg_starts, on_leaf, on_unleaf)
        return count if count else fetched

    def _clear_leaf_buffer(self, root: bytes, on_unleaf=None) -> None:
        """Drop buffered leaves for [root] — and, when discarding
        UNVERIFIED data (on_unleaf set), undo the snapshot entries those
        leaves wrote, so a lying peer's phantom keys don't survive."""
        batch = self.diskdb.new_batch()
        n = 0
        prefix = SYNC_LEAF_PREFIX + root
        for full_key, _v in self.diskdb.iterate(prefix):
            if on_unleaf is not None:
                on_unleaf(full_key[len(prefix):], batch)
            batch.delete(full_key)
            n += 1
            if n % 4096 == 0:
                batch.write()
                batch = self.diskdb.new_batch()
        batch.write()

    def _fetch_segment(self, root: bytes, on_leaf, seg_start: bytes,
                       seg_end: bytes) -> int:
        """Stream one key-range segment; every batch lands with its resume
        marker atomically. seg_end is the INCLUSIVE last key served."""
        key = sync_segment_key(root, seg_start)
        marker = self.diskdb.get(key)
        if marker == _SEG_DONE:
            return 0
        start = marker[1:] if marker else seg_start
        count = 0
        empty_more = 0
        disagreements = 0
        while True:
            resp = self.client.get_leafs(
                root, start=start, end=seg_end, limit=self.leaf_limit)
            batch = self.diskdb.new_batch()
            for k, v in zip(resp.keys, resp.vals):
                batch.put(sync_leaf_key(root, k), v)
                on_leaf(k, v, batch)
                count += 1
            if resp.keys and resp.more:
                start = _next_key(resp.keys[-1])
                batch.put(key, b"S" + start)
                batch.write()
                empty_more = 0
                continue
            if resp.more:
                # zero keys but "more": a deadline-pressured server served
                # nothing this round — retry the same range (bounded)
                # instead of stamping DONE over an unfinished segment
                batch.write()
                empty_more += 1
                if empty_more > 5:
                    raise StateSyncError(
                        f"segment {seg_start.hex()[:8]} starves: server "
                        "keeps answering empty with more=True"
                    )
                continue
            # The peer claims the segment is drained. A lying more=False
            # on an end-bounded request is invisible to per-batch proof
            # validation (keys legitimately exist past the segment end),
            # so before stamping DONE, cross-examine a SECOND peer —
            # skipped when the response provably reached the segment end,
            # or when there is no second peer to ask (single-peer wirings
            # keep their exact request counts).
            nxt = _next_key(resp.keys[-1]) if resp.keys else start
            reached_end = bool(resp.keys) and resp.keys[-1] >= seg_end
            if (self.drain_confirm and not reached_end
                    and self._peer_count() >= 2
                    and not self._confirm_drained(
                        root, nxt, seg_end, getattr(resp, "peer", None))):
                disagreements += 1
                if disagreements > 16:
                    raise StateSyncError(
                        f"segment {seg_start.hex()[:8]}: drained claims "
                        "keep being contradicted by other peers")
                batch.put(key, b"S" + nxt)
                batch.write()
                start = nxt
                continue
            batch.put(key, _SEG_DONE)
            batch.write()
            return count

    def _peer_count(self) -> int:
        counter = getattr(self.client, "peer_count", None)
        # clients without a peer set (test fakes) have no second opinion
        return counter() if counter is not None else 1

    def _confirm_drained(self, root: bytes, start: bytes, seg_end: bytes,
                         claimer: Optional[bytes]) -> bool:
        """Ask a peer OTHER than [claimer] whether [start, seg_end] is
        really empty. Proof-backed leaves from the confirmer are hard
        evidence the claimer truncated its stream — score it at proof
        weight. An honest-but-empty disagreement cannot be fabricated:
        the confirmer's keys must themselves range-proof against root."""
        try:
            confirm = self.client.get_leafs(
                root, start=start, end=seg_end, limit=self.leaf_limit,
                exclude={claimer} if claimer else None)
        except RootUnavailableError:
            raise
        except ClientError:
            return True  # no usable second opinion: accept the claim
        if confirm.keys or confirm.more:
            self.client.report_peer(claimer, FAIL_PROOF)
            default_registry.counter("sync/drain_disagreements").inc()
            self._note("sync/drain_disagreement", root=root.hex()[:12],
                       claimer=claimer.hex() if claimer else "?")
            return False
        return True

    def _rebuild_from_buffer(self, root: bytes, seg_starts, on_leaf,
                             on_unleaf=None) -> int:
        """One ordered StackTrie pass over the buffered leaves: persists
        the trie nodes, REPLAYS on_leaf (so a resumed sync re-derives the
        storage/code tasks its crashed predecessor collected only in
        memory), and verifies the root over the FULL keyspace. Cleanup
        order is crash-safe: markers clear in the same batch as the trie
        nodes, the buffer strictly after — a crash mid-cleanup leaves
        either a fully-markered buffer (rebuild replays) or no markers
        plus stray buffer entries (cleared at the next sync's switch)."""
        failpoint("sync/before_rebuild")
        self._note("sync/rebuild_start", root=root.hex()[:12])
        batch = self.diskdb.new_batch()

        def write_node(path: bytes, node_hash: bytes, blob: bytes) -> None:
            batch.put(node_hash, blob)

        st = StackTrie(write_fn=write_node)
        prefix = SYNC_LEAF_PREFIX + root
        count = 0
        # nodes/snapshot writes stream out in chunks — hash-keyed blobs are
        # self-verifying, so pre-verification flushes can at worst orphan
        # garbage (same as a crash), never corrupt; memory stays O(chunk)
        for full_key, v in self.diskdb.iterate(prefix):
            leaf_key = full_key[len(prefix):]
            st.update(leaf_key, v)
            on_leaf(leaf_key, v, batch)
            count += 1
            if count % 4096 == 0:
                batch.write()
                batch = self.diskdb.new_batch()
        got = st.hash()
        if got != root:
            # a lying peer's truncated more=False can only surface here;
            # reset the segment state so the NEXT attempt (likely against
            # an honest peer) refetches instead of wedging forever on
            # done-marked holes. The buffer clear also undoes the
            # snapshot entries the unverified leaves wrote (on_unleaf).
            default_registry.counter("sync/rebuild_mismatch").inc()
            self._note("sync/rebuild_mismatch", want=root.hex()[:12],
                       got=got.hex()[:12])
            batch = self.diskdb.new_batch()
            for s in seg_starts:
                batch.delete(sync_segment_key(root, s))
            batch.write()
            self._clear_leaf_buffer(root, on_unleaf)
            raise StateSyncError(
                f"segmented rebuild root mismatch: want {root.hex()[:12]} "
                f"got {got.hex()[:12]} (segment state reset for refetch)"
            )
        # 1) remaining nodes + replayed side effects + marker clear: one batch
        for s in seg_starts:
            batch.delete(sync_segment_key(root, s))
        batch.write()
        # 2) buffer clear, strictly after the markers are gone
        self._clear_leaf_buffer(root)
        return count

    # --- dynamic pivot ------------------------------------------------------

    def pivot(self, new_root: bytes) -> None:
        """Re-target an in-flight sync to [new_root] (the stale-root
        escape hatch): SEGMENTED progress — resume markers and the
        on-disk leaf buffer — carries forward under the new root instead
        of restarting from zero. Carried leaves are best-effort: any that
        changed between summaries make the terminal rebuild root check
        fail, which resets segment state and refetches (the standard
        lying-peer self-heal). Unsegmented resume markers are dropped —
        that path persists leaves un-buffered, so its partial progress
        cannot be re-verified under a different root.

        Copy-then-delete ordering keeps a crash mid-pivot safe: strays
        under either root are unreferenced garbage cleared at the next
        switch, never lost markered data."""
        old = self.root
        if new_root == old:
            return
        failpoint("sync/before_pivot")
        seg_starts = _segment_bounds(NUM_SEGMENTS)
        batch = self.diskdb.new_batch()
        for s in seg_starts:
            v = self.diskdb.get(sync_segment_key(old, s))
            if v is not None:
                batch.put(sync_segment_key(new_root, s), v)
        batch.write()
        old_prefix = SYNC_LEAF_PREFIX + old
        batch = self.diskdb.new_batch()
        carried = 0
        for full_key, v in self.diskdb.iterate(old_prefix):
            batch.put(sync_leaf_key(new_root, full_key[len(old_prefix):]), v)
            carried += 1
            if carried % 4096 == 0:
                batch.write()
                batch = self.diskdb.new_batch()
        batch.write()
        batch = self.diskdb.new_batch()
        for s in seg_starts:
            batch.delete(sync_segment_key(old, s))
        batch.delete(sync_storage_key(old, b""))
        n = 0
        for full_key, _v in self.diskdb.iterate(old_prefix):
            batch.delete(full_key)
            n += 1
            if n % 4096 == 0:
                batch.write()
                batch = self.diskdb.new_batch()
        batch.write()
        with self.lock:
            # task state was derived under the old root; sync() re-derives
            self.storage_tasks = []
            self.code_hashes = set()
            self.synced_storage_roots = set()
            self.root = new_root
            self.pivots.append((old, new_root))
        default_registry.counter("sync/pivots").inc()
        self._note("sync/pivot", old=old.hex()[:12], new=new_root.hex()[:12],
                   carried_leaves=carried)

    # --- main account trie ------------------------------------------------

    def sync(self) -> None:
        """syncStateTrie: account trie → storage tasks + code, then drain."""

        def on_account_leaf(key_hash: bytes, value: bytes, batch) -> None:
            acct = Account.decode(value)
            batch.put(account_snapshot_key(key_hash), _account_to_slim(acct))
            if acct.root != EMPTY_ROOT:
                with self.lock:
                    self.storage_tasks.append((key_hash, acct.root))
            if acct.code_hash != EMPTY_CODE_HASH:
                with self.lock:
                    self.code_hashes.add(acct.code_hash)

        def un_account_leaf(key_hash: bytes, batch) -> None:
            batch.delete(account_snapshot_key(key_hash))

        with self.lock:
            # re-runnable after a pivot or self-heal: task state is
            # re-derived from the (replayed) account leaves every run
            self.storage_tasks = []
            self.phase = "accounts"
        self._note("sync/phase", phase="accounts", root=self.root.hex()[:12])
        self._sync_trie(self.root, on_account_leaf,
                        on_unleaf=un_account_leaf)

        with self.lock:
            self.phase = "storage"
        self._note("sync/phase", phase="storage",
                   tasks=len(self.storage_tasks))
        # storage tries (deduped by root — identical contracts share; owner
        # sets dedupe the rebuild pass's on_leaf replay)
        futures = []
        seen_roots: Dict[bytes, Set[bytes]] = {}
        for account_hash, storage_root in self.storage_tasks:
            seen_roots.setdefault(storage_root, set()).add(account_hash)
        for storage_root, owners in seen_roots.items():
            futures.append(
                self._workers().submit(
                    self._sync_storage_trie, storage_root, sorted(owners))
            )
        for f in futures:
            f.result()

        with self.lock:
            self.phase = "code"
        self._note("sync/phase", phase="code", hashes=len(self.code_hashes))
        self._sync_code()
        with self.lock:
            self.phase = "done"
        self._note("sync/phase", phase="done")

    def status(self) -> dict:
        """Progress snapshot for the debug_syncStatus RPC."""
        seg_starts = _segment_bounds(NUM_SEGMENTS)
        segments = {}
        for s in seg_starts:
            m = self.diskdb.get(sync_segment_key(self.root, s))
            if m == _SEG_DONE:
                segments[s.hex()[:8]] = "done"
            elif m is None:
                segments[s.hex()[:8]] = "virgin"
            else:
                segments[s.hex()[:8]] = "at:" + m[1:].hex()[:16]
        with self.lock:
            return {
                "root": self.root.hex(),
                "phase": self.phase,
                "segments": segments,
                "storageTasks": len(self.storage_tasks),
                "storageSynced": len(self.synced_storage_roots),
                "codeHashes": len(self.code_hashes),
                "pivots": [
                    {"from": o.hex()[:12], "to": n.hex()[:12]}
                    for o, n in self.pivots
                ],
            }

    def _sync_storage_trie(self, storage_root: bytes, owners: List[bytes]) -> None:
        def on_storage_leaf(slot_hash: bytes, value: bytes, batch) -> None:
            for owner in owners:
                batch.put(storage_snapshot_key(owner, slot_hash), value)

        def un_storage_leaf(slot_hash: bytes, batch) -> None:
            for owner in owners:
                batch.delete(storage_snapshot_key(owner, slot_hash))

        self._sync_trie(storage_root, on_storage_leaf, account=owners[0],
                        on_unleaf=un_storage_leaf)
        with self.lock:
            self.synced_storage_roots.add(storage_root)

    # --- code -------------------------------------------------------------

    def _sync_code(self) -> None:
        """code_syncer.go: fetch code blobs in batches of 5."""
        hashes = [h for h in self.code_hashes if rawdb.read_code(self.diskdb, h) is None]
        for i in range(0, len(hashes), 5):
            chunk = hashes[i : i + 5]
            blobs = self.client.get_code(chunk)
            for h, code in zip(chunk, blobs):
                rawdb.write_code(self.diskdb, h, code)


def _next_key(key: bytes) -> bytes:
    """Smallest key greater than [key]."""
    v = int.from_bytes(key, "big") + 1
    return v.to_bytes(len(key), "big")


def _segment_ends(seg_starts) -> List[bytes]:
    """INCLUSIVE last key per segment (the wire's `end` bound is
    inclusive; the final segment runs to the keyspace maximum)."""
    ends = []
    for nxt in seg_starts[1:]:
        v = int.from_bytes(nxt, "big") - 1
        ends.append(v.to_bytes(32, "big"))
    ends.append(b"\xff" * 32)
    return ends
