"""Offline state pruning and shutdown tracking (semantics of coreth
core/state/pruner/pruner.go and internal/shutdowncheck/
shutdown_tracker.go); counterpart of coreth_tpu/core/pruner.py, with the
same marks and the same deletions.

The pruner mark-sweeps stale trie nodes on the host: mark every node
reachable from the target root (and the genesis root, kept for replays),
then delete all other hash-keyed trie nodes from disk. The reference uses
a bloom filter to bound memory over a full disk walk; here the mark set
holds exact hashes with the same two-phase structure. recover_pruning
resumes an interrupted prune on boot from its progress marker, as
pruner.RecoverPruning does.

A resident chain keeps its newest nodes on the device until an export
writes them (core/state_manager.ResidentTrieWriter; stop() writes the
shutdown export), so prune a resident chain's store only after stop().
The sweep takes every 32-byte key that the state trie and its storage
tries do not reach: on a VM's store that includes the atomic trie's
committed nodes, in both packages (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Set

from .. import rlp
from ..metrics import count_drop
from ..trie.node import EMPTY_ROOT, ShortNode, ValueNode, must_decode_node
from ..trie.triedb import _child_hashes

PRUNING_IN_PROGRESS_KEY = b"PruningInProgress"
UNCLEAN_SHUTDOWN_KEY = b"unclean-shutdown"  # rawdb uncleanShutdownKey


class Pruner:
    def __init__(self, diskdb, triedb):
        self.diskdb = diskdb
        self.triedb = triedb

    def _mark(self, root: bytes, marked: Set[bytes]) -> None:
        if root == EMPTY_ROOT or root in marked:
            return
        stack = [root]
        while stack:
            h = stack.pop()
            if h in marked:
                continue
            blob = self.diskdb.get(h)
            if blob is None:
                blob = self.triedb.node(b"", h)
            if blob is None:
                continue
            marked.add(h)
            for child in _child_hashes(blob):
                stack.append(child)
            # account leaves embed storage roots + code hashes
            self._mark_account_refs(blob, marked, stack)

    def _mark_account_refs(self, blob: bytes, marked: Set[bytes], stack) -> None:
        try:
            n = must_decode_node(None, blob)
        except Exception:
            # an undecodable account-trie node during mark = refs silently
            # missed = live storage swept; make the skip visible
            count_drop("core/pruner/account_node_decode_error")
            return

        def visit(node):
            if isinstance(node, ShortNode) and isinstance(node.val, (bytes, ValueNode)):
                try:
                    fields = rlp.decode(bytes(node.val))
                except Exception:
                    count_drop("core/pruner/account_leaf_decode_error")
                    return
                if isinstance(fields, list) and len(fields) >= 4:
                    storage_root = fields[2]
                    if isinstance(storage_root, bytes) and len(storage_root) == 32:
                        stack.append(storage_root)

        visit(n)

    def prune(self, target_root: bytes, genesis_root: Optional[bytes] = None) -> int:
        """Delete trie nodes unreachable from [target_root]/[genesis_root];
        returns the number of deleted nodes."""
        self.diskdb.put(PRUNING_IN_PROGRESS_KEY, target_root)
        marked: Set[bytes] = set()
        self._mark(target_root, marked)
        if genesis_root is not None:
            self._mark(genesis_root, marked)

        deleted = 0
        batch = self.diskdb.new_batch()
        for key, _ in list(self.diskdb.iterate()):
            # hash-keyed trie nodes are exactly 32-byte keys in this schema
            if len(key) == 32 and key not in marked:
                batch.delete(key)
                deleted += 1
        batch.write()
        self.diskdb.delete(PRUNING_IN_PROGRESS_KEY)
        return deleted

    def recover_pruning(self, genesis_root: Optional[bytes] = None) -> bool:
        """Resume an interrupted prune (pruner.RecoverPruning); True if a
        recovery ran."""
        target = self.diskdb.get(PRUNING_IN_PROGRESS_KEY)
        if target is None:
            return False
        self.prune(target, genesis_root)
        return True


class ShutdownTracker:
    """Marks unclean shutdowns (shutdown_tracker.go:48-90): a marker is
    written on start and removed on clean stop; finding one at boot means
    the previous run died and state may need reprocessing."""

    def __init__(self, diskdb):
        self.diskdb = diskdb

    def mark_start(self) -> bool:
        """Returns True if the previous shutdown was unclean."""
        unclean = self.diskdb.get(UNCLEAN_SHUTDOWN_KEY) is not None
        self.diskdb.put(UNCLEAN_SHUTDOWN_KEY, b"\x01")
        return unclean

    def done(self) -> None:
        self.diskdb.delete(UNCLEAN_SHUTDOWN_KEY)
