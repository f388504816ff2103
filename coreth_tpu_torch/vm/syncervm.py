"""State-sync VM orchestration (role of coreth plugin/evm/
{syncervm_client,syncervm_server}.go); counterpart of
coreth_tpu/vm/syncervm.py.

Server side: serve state summaries at commit-interval heights from
committed roots (syncervm_server.go). Client side: accept a summary →
fetch 256 parent blocks → sync the state trie (+ snapshot population) →
reset the chain to the synced block (syncervm_client.go:148-330,
blockchain.go:2051 ResetToStateSyncedBlock).

The device: `_finish` reboots the client chain's resident mirror over the
synced account trie (BlockChain.reboot_mirror) on the chain's own device,
so on CUDA the mirror's genesis commit and every later block's account
trie run on K1. A device fault there reaches the caller of
accept_summary; nothing falls back to the host. The synced atomic trie
keeps the VM's device seam (AtomicSyncer's batch_keccak)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..core import rawdb
from ..core.types import Block as EthBlock
from ..fault import Backoff
from ..metrics import count_drop
from ..sync.client import RootUnavailableError, SyncClient
from ..sync.messages import SyncSummary
from ..sync.statesync import StateSyncer, StateSyncError

PARENTS_TO_FETCH = 256  # syncervm_client.go:237 parentsToGet
SYNCABLE_INTERVAL = 16384  # state sync summary cadence (sync README)

# resume marker (syncervm_client.go:111-140 summary persistence)
SYNC_SUMMARY_KEY = b"stateSyncSummary"

MAX_PIVOTS = 4       # re-targets before the sync gives up
MAX_SELF_HEALS = 3   # rebuild-mismatch resets before the sync gives up


class StateSyncServer:
    """GetLastStateSummary/GetStateSummaryByHeight (syncervm_server.go)."""

    def __init__(self, chain, syncable_interval: int = SYNCABLE_INTERVAL,
                 vm=None):
        self.chain = chain
        self.syncable_interval = syncable_interval
        self.vm = vm

    def get_last_state_summary(self) -> Optional[SyncSummary]:
        h = self.chain.last_accepted.number
        height = (h // self.syncable_interval) * self.syncable_interval
        return self.get_state_summary(height)

    def get_state_summary(self, height: int) -> Optional[SyncSummary]:
        if height % self.syncable_interval != 0:
            return None
        blk = self.chain.get_block_by_number(height)
        if blk is None or not self.chain.has_state(blk.root):
            return None
        atomic_root = b"\x00" * 32
        if self.vm is not None and getattr(self.vm, "atomic_trie", None) is not None:
            atomic_root, _ = self.vm.atomic_trie.root_at()
        return SyncSummary(blk.number, blk.hash(), blk.root, atomic_root)


class StateSyncClient:
    """stateSyncerClient orchestration (syncervm_client.go:148-330).

    [summary_provider] supplies the freshest syncable summary on demand
    (typically a closure over the peer set); when the in-flight root
    goes stale (RootUnavailableError), the sync PIVOTS to it instead of
    failing — segment markers and buffered leaves carry forward."""

    def __init__(self, vm, client: SyncClient,
                 summary_provider: Optional[Callable[[], Optional[SyncSummary]]] = None,
                 max_pivots: int = MAX_PIVOTS):
        self.vm = vm
        self.client = client
        self.summary_provider = summary_provider
        self.max_pivots = max_pivots
        self.state_syncer: Optional[StateSyncer] = None
        self.pivot_history: List[dict] = []
        # the debug_syncStatus RPC finds us through the VM
        vm.state_sync_client = self

    def _flight_note(self):
        chain = getattr(self.vm, "blockchain", None)
        rec = getattr(chain, "flight_recorder", None)
        return rec.note_event if rec is not None else None

    def status(self) -> dict:
        """debug_syncStatus payload: peers by ladder state, segment
        progress, pivot history."""
        network = getattr(self.client, "network", None)
        peers = network.tracker.status() if network is not None else {}
        by_state: dict = {}
        for info in peers.values():
            by_state[info["state"]] = by_state.get(info["state"], 0) + 1
        out = {
            "peers": peers,
            "peersByState": by_state,
            "pivots": list(self.pivot_history),
        }
        if self.state_syncer is not None:
            out["trie"] = self.state_syncer.status()
        return out

    def accept_summary(self, summary: SyncSummary) -> None:
        """acceptSyncSummary (:164): persist for resume, then run the sync
        to completion (the reference does this on a goroutine; callers may
        wrap this in a thread)."""
        diskdb = self.vm.blockchain.diskdb
        if diskdb.get(SYNC_SUMMARY_KEY) is None:
            # FRESH sync (not a resume — a resume's markered ranges wrote
            # their snapshot entries already and must keep them): wipe
            # pre-sync flat-snapshot entries so keys that exist locally
            # but not in the synced state can never survive as phantoms
            # (the reference resets snapshot generation on sync start)
            from ..state.snapshot import (
                SNAPSHOT_ACCOUNT_PREFIX,
                SNAPSHOT_STORAGE_PREFIX,
            )

            batch = diskdb.new_batch()
            # exact schema lengths only: hash-keyed trie nodes (32 B) and
            # other rawdb keys can share a first byte with these prefixes
            for prefix, klen in ((SNAPSHOT_ACCOUNT_PREFIX, 33),
                                 (SNAPSHOT_STORAGE_PREFIX, 65)):
                for k, _v in diskdb.iterate(prefix):
                    if len(k) == klen:
                        batch.delete(k)
            batch.write()
        diskdb.put(SYNC_SUMMARY_KEY, summary.encode())
        self.state_sync(summary)
        diskdb.delete(SYNC_SUMMARY_KEY)

    def ongoing_summary(self) -> Optional[SyncSummary]:
        """Resume support: a persisted summary means a sync was interrupted."""
        blob = self.vm.blockchain.diskdb.get(SYNC_SUMMARY_KEY)
        return SyncSummary.decode(blob) if blob else None

    def state_sync(self, summary: SyncSummary) -> None:
        summary = self._sync_until_complete(summary)
        self._sync_atomic_trie(summary)
        self._finish(summary)

    def _sync_until_complete(self, summary: SyncSummary) -> SyncSummary:
        """Blocks + state trie with pivot/self-heal orchestration; returns
        the summary the sync actually completed at (it moves on pivot)."""
        diskdb = self.vm.blockchain.diskdb
        syncer = self._make_syncer(summary.block_root)
        self.state_syncer = syncer
        backoff = Backoff(base=0.05, cap=2.0)
        pivots = heals = 0
        fetch_blocks = True
        try:
            while True:
                if fetch_blocks:
                    self._sync_blocks(summary)
                    fetch_blocks = False
                try:
                    syncer.sync()
                    return summary
                except RootUnavailableError:
                    newer = self._next_summary(summary)
                    if newer is None or pivots >= self.max_pivots:
                        raise
                    pivots += 1
                    syncer.pivot(newer.block_root)
                    # the resume marker must follow the pivot: a crash
                    # after this point resumes against the NEW summary,
                    # whose markers/buffer the pivot just carried over
                    diskdb.put(SYNC_SUMMARY_KEY, newer.encode())
                    self.pivot_history.append({
                        "fromHeight": summary.block_number,
                        "toHeight": newer.block_number,
                        "toRoot": newer.block_root.hex()[:16],
                    })
                    summary = newer
                    fetch_blocks = True
                except StateSyncError:
                    # rebuild mismatch reset its own segment state; a
                    # bounded retry against (now re-ranked) peers heals it
                    heals += 1
                    if heals > MAX_SELF_HEALS:
                        raise
                    backoff.sleep()
        finally:
            syncer.close()  # the pre-fix executor leak

    def _make_syncer(self, root: bytes) -> StateSyncer:
        return StateSyncer(
            self.client, self.vm.blockchain.diskdb, root,
            note_event=self._flight_note(),
        )

    def _next_summary(self, current: SyncSummary) -> Optional[SyncSummary]:
        """A STRICTLY newer summary from the provider, or None."""
        if self.summary_provider is None:
            return None
        try:
            cand = self.summary_provider()
        except Exception:
            count_drop("sync/drops/summary_provider_error")
            return None
        if (cand is None or cand.block_number <= current.block_number
                or cand.block_root == current.block_root):
            return None
        return cand

    def _sync_atomic_trie(self, summary: SyncSummary) -> None:
        """syncAtomicTrie (:284): rebuild the indexed atomic ops and replay
        them into this node's shared memory."""
        from ..trie.node import EMPTY_ROOT
        from .atomic_trie import AtomicSyncer

        if summary.atomic_root in (b"\x00" * 32, EMPTY_ROOT):
            return
        current = getattr(self.vm, "atomic_trie", None)
        syncer = AtomicSyncer(
            self.client, self.vm.blockchain.diskdb,
            summary.atomic_root, summary.block_number,
            batch_keccak=(current.triedb.batch_keccak
                          if current is not None else None),
        )
        syncer.sync()
        self.vm.atomic_trie = syncer.trie
        syncer.trie.apply_to_shared_memory(
            self.vm.shared_memory, summary.block_number
        )

    def _sync_blocks(self, summary: SyncSummary) -> None:
        """syncBlocks (:237): fetch 256 parents so the chain can verify
        descendants without gaps."""
        blobs = self.client.get_blocks(
            summary.block_hash, summary.block_number, PARENTS_TO_FETCH
        )
        diskdb = self.vm.blockchain.diskdb
        for blob in blobs:
            blk = EthBlock.decode(blob)
            h, n = blk.hash(), blk.number
            rawdb.write_header_number(diskdb, h, n)
            rawdb.write_header_rlp(diskdb, n, h, blk.header.encode())
            from .. import rlp

            body_items = [
                [rlp.decode(t.encode()) if t.type == 0 else t.encode()
                 for t in blk.transactions],
                [u.rlp_items() for u in blk.uncles],
                blk.version,
                blk.ext_data if blk.ext_data is not None else b"",
            ]
            rawdb.write_body_rlp(diskdb, n, h, rlp.encode(body_items))
            rawdb.write_canonical_hash(diskdb, h, n)

    def _sync_state_trie(self, summary: SyncSummary) -> None:
        """Single-shot trie sync (no pivot orchestration) — kept for
        callers that manage their own retry policy."""
        syncer = self._make_syncer(summary.block_root)
        self.state_syncer = syncer
        try:
            syncer.sync()
        finally:
            syncer.close()

    def _finish(self, summary: SyncSummary) -> None:
        """ResetToStateSyncedBlock (blockchain.go:2051): move chain pointers
        to the synced block and mark it accepted."""
        chain = self.vm.blockchain
        blk = chain.get_block(summary.block_hash)
        if blk is None:
            raise RuntimeError("synced block missing after block sync")
        if not chain.has_state(blk.root):
            raise RuntimeError("synced state missing after trie sync")
        rawdb.write_head_block_hash(chain.diskdb, blk.hash())
        chain._canonical[blk.number] = blk.hash()
        chain.current_block = blk
        chain.last_accepted = blk
        # resident mode: the mirror's base is the pre-sync state and can
        # never reach the synced root by replay — reboot it over the
        # freshly synced account trie so post-sync blocks verify through
        # the device-resident path
        chain.reboot_mirror()
        # the flat snapshot was populated leaf by leaf during the trie
        # sync; stamp the disk markers and re-anchor the layer tree at
        # the synced block so post-sync commits build diff layers on it
        # (the pre-sync tree is anchored at genesis — its layers can
        # never parent a post-sync block's diff)
        if chain.snaps is not None:
            from ..state.snapshot import (
                SNAPSHOT_BLOCK_HASH_KEY,
                SNAPSHOT_ROOT_KEY,
                Tree as SnapshotTree,
            )

            chain.diskdb.put(SNAPSHOT_ROOT_KEY, blk.root)
            chain.diskdb.put(SNAPSHOT_BLOCK_HASH_KEY, blk.hash())
            chain.snaps = SnapshotTree(
                chain.diskdb, chain.state_database.triedb,
                blk.root, block_hash=blk.hash(),
            )
        # the head pointers moved out of band: re-publish the read view
        # so lock-free readers land on the synced block (and the rebuilt
        # snapshot tree) rather than the pre-sync heads
        chain._publish_read_view()
        from .block import BlockStatus, VMBlock

        vmb = VMBlock(self.vm, blk)
        vmb.status = BlockStatus.ACCEPTED
        self.vm.last_accepted_vm_block = vmb
        self.vm.preferred_block = vmb
