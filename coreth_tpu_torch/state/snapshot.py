"""Flat account/storage snapshot tree (semantics of coreth
core/state/snapshot/ — disk layer + diff-layer DAG); counterpart of
coreth_tpu/state/snapshot.py.

Coreth's departure from geth: layers are keyed by **block hash**, with a
root→layers index alongside (`Tree.blockLayers/stateLayers`,
snapshot.go:186-196), because distinct Avalanche blocks can carry identical
state roots (empty blocks). Reads walk diff layers toward the disk layer;
Flatten(blockHash) folds an accepted block's layer into the disk layer and
discards sibling branches. Serves O(1) state reads during execution and
leaf serving for state sync.

The flat entries share the key space with the trie nodes, which the hashdb
scheme keys by their bare 32-byte hash: a node whose hash starts with b"a"
or b"o" sits under the snapshot prefixes. Every scan of those prefixes
here takes only keys of the snapshot's own lengths (33 for an account, 65
for a slot), as geth's wipeKeyRange and snapshot iterators do. The
reference scans by prefix alone, so its generation deletes such trie
nodes and its iterators yield them (ROADMAP Queue 3).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set, Tuple

from ..log import get_logger
from ..metrics import default_registry as _metrics

_log = get_logger("snapshot")

# rawdb snapshot schema (core/rawdb/schema.go SnapshotAccountPrefix etc.)
SNAPSHOT_ACCOUNT_PREFIX = b"a"
SNAPSHOT_STORAGE_PREFIX = b"o"
SNAPSHOT_ROOT_KEY = b"SnapshotRoot"
SNAPSHOT_BLOCK_HASH_KEY = b"SnapshotBlockHash"


ACCOUNT_KEY_LEN = 1 + 32
STORAGE_KEY_LEN = 1 + 32 + 32


def _flat(diskdb, prefix: bytes, key_len: int, start: bytes = b""):
    """(key, value) of diskdb under `prefix` whose key is `key_len` bytes
    long: the snapshot's entries, not trie nodes that share the prefix."""
    return ((k, v) for k, v in diskdb.iterate(prefix=prefix, start=start)
            if len(k) == key_len)


def account_snapshot_key(addr_hash: bytes) -> bytes:
    return SNAPSHOT_ACCOUNT_PREFIX + addr_hash


def storage_snapshot_key(addr_hash: bytes, slot_hash: bytes) -> bytes:
    return SNAPSHOT_STORAGE_PREFIX + addr_hash + slot_hash


class SnapshotError(Exception):
    pass


def _merge_sources(sources):
    """k-way merge of [(priority, iter[(key, value)])]: ascending by key,
    LOWEST priority (youngest layer) wins ties; b"" values (deletions /
    destructs) suppress the key entirely."""
    import heapq

    heads = []
    for prio, it in sources:
        for k, v in it:
            heads.append((k, prio, v, it))
            break
    heapq.heapify(heads)
    last_key = None
    while heads:
        k, prio, v, it = heapq.heappop(heads)
        if k != last_key:
            last_key = k
            if v != b"":
                yield k, v
        for nk, nv in it:
            heapq.heappush(heads, (nk, prio, nv, it))
            break


class DiskLayer:
    """Persisted base layer (disklayer.go). `ready` is False while the
    background generator is still populating it (generate.go) — reads
    raise until generation completes, so callers fall back to the trie."""

    def __init__(self, diskdb, root: bytes, block_hash: bytes,
                 ready: bool = True):
        self.diskdb = diskdb
        self.root = root
        self.block_hash = block_hash
        self.stale = False
        self.ready = ready

    def _check(self):
        if self.stale:
            raise SnapshotError("stale disk layer read")
        if not self.ready:
            raise SnapshotError("snapshot generation in progress")

    def account(self, addr_hash: bytes) -> Optional[bytes]:
        self._check()
        return self.diskdb.get(account_snapshot_key(addr_hash))

    def storage(self, addr_hash: bytes, slot_hash: bytes) -> Optional[bytes]:
        self._check()
        return self.diskdb.get(storage_snapshot_key(addr_hash, slot_hash))

    def parent(self):
        return None


class DiffLayer:
    """In-memory delta on top of a parent layer (difflayer.go)."""

    def __init__(self, parent, root: bytes, block_hash: bytes,
                 destructs: Set[bytes], accounts: Dict[bytes, bytes],
                 storage: Dict[bytes, Dict[bytes, bytes]]):
        self._parent = parent
        self.root = root
        self.block_hash = block_hash
        self.destructs = set(destructs)
        self.accounts = dict(accounts)       # addr_hash -> slim RLP (b"" = del)
        # named storage_data: `storage` is the read method
        self.storage_data = {k: dict(v) for k, v in storage.items()}
        self.stale = False

    def parent(self):
        return self._parent

    def account(self, addr_hash: bytes) -> Optional[bytes]:
        if self.stale:
            raise SnapshotError("stale diff layer read")
        if addr_hash in self.accounts:
            return self.accounts[addr_hash] or b""
        if addr_hash in self.destructs:
            return b""
        return self._parent.account(addr_hash)

    def storage(self, addr_hash: bytes, slot_hash: bytes) -> Optional[bytes]:
        if self.stale:
            raise SnapshotError("stale diff layer read")
        acct = self.storage_data.get(addr_hash)
        if acct is not None and slot_hash in acct:
            return acct[slot_hash]
        if addr_hash in self.destructs and (
            acct is None or slot_hash not in acct
        ):
            return b""
        if addr_hash in self.accounts and self.accounts[addr_hash] == b"":
            return b""
        return self._parent.storage(addr_hash, slot_hash)


class Tree:
    """Snapshot tree keyed by block hash + root index (snapshot.go Tree)."""

    def __init__(self, diskdb, triedb, root: bytes,
                 block_hash: bytes = b"\x00" * 32, generate: bool = True,
                 verify: bool = False, async_generate: bool = False):
        self.diskdb = diskdb
        self.triedb = triedb
        self.lock = threading.RLock()
        # the diff-layer stack: every structural mutation (register,
        # unregister, re-parent, flatten) happens under self.lock
        self.block_layers: Dict[bytes, object] = {}  # guarded-by: lock
        self.state_layers: Dict[bytes, Dict[bytes, object]] = {}  # guarded-by: lock
        self._gen_thread: Optional[threading.Thread] = None

        stored_root = diskdb.get(SNAPSHOT_ROOT_KEY)
        stored_bh = diskdb.get(SNAPSHOT_BLOCK_HASH_KEY)
        if stored_root == root and stored_root is not None:
            base = DiskLayer(diskdb, root, stored_bh or block_hash)
        elif generate:
            # record the generating block hash too, or a later restart
            # would adopt a stale hash and break parent-layer lookups
            diskdb.put(SNAPSHOT_BLOCK_HASH_KEY, block_hash)
            base = DiskLayer(diskdb, root, block_hash, ready=not async_generate)
            if async_generate:
                # generate.go: the disk layer builds in the background;
                # reads fall back to the trie until it's ready
                def _bg():
                    try:
                        self._generate(root)
                        base.ready = True
                    except Exception as exc:
                        # layer stays not-ready; trie remains truth — but a
                        # silent failure would leave every read paying the
                        # trie walk forever with nothing to show why
                        _metrics.counter("state/snap/generation_error").inc()
                        _log.warning(
                            "snapshot generation failed for root %s: %s",
                            root.hex()[:12], exc,
                        )

                self._gen_thread = threading.Thread(target=_bg, daemon=True)
                self._gen_thread.start()
            else:
                self._generate(root)
        else:
            raise SnapshotError("snapshot missing and generation disabled")
        self._register(base)
        self.disk_layer = base

    def wait_generation(self, timeout: Optional[float] = None) -> bool:
        """Block until background generation finishes; True when ready."""
        t = self._gen_thread
        if t is not None:
            t.join(timeout)
        return self.disk_layer.ready

    # ------------------------------------------------------------ structure

    def _register(self, layer) -> None:  # guarded-by: lock
        self.block_layers[layer.block_hash] = layer
        self.state_layers.setdefault(layer.root, {})[layer.block_hash] = layer

    def _unregister(self, layer) -> None:  # guarded-by: lock
        self.block_layers.pop(layer.block_hash, None)
        by_root = self.state_layers.get(layer.root)
        if by_root is not None:
            by_root.pop(layer.block_hash, None)
            if not by_root:
                del self.state_layers[layer.root]

    def snapshot(self, root: bytes):
        """Any layer carrying [root] (statedb read entry)."""
        with self.lock:
            by_root = self.state_layers.get(root)
            if not by_root:
                return None
            return next(iter(by_root.values()))

    def get_block_snapshot(self, block_hash: bytes):
        with self.lock:
            return self.block_layers.get(block_hash)

    # --------------------------------------------------------------- update

    def update(self, root: bytes, parent_root: bytes,
               destructs: Set[bytes], accounts: Dict[bytes, bytes],
               storage: Dict[bytes, Dict[bytes, bytes]],
               block_hash: Optional[bytes] = None,
               parent_block_hash: Optional[bytes] = None) -> None:
        """Attach a new diff layer (snapshot.go Update)."""
        with self.lock:
            if parent_block_hash is not None:
                parent = self.block_layers.get(parent_block_hash)
            else:
                parent = self.snapshot(parent_root)
            if parent is None:
                raise SnapshotError(
                    f"parent snapshot missing (root {parent_root.hex()[:12]})"
                )
            bh = block_hash if block_hash is not None else root
            layer = DiffLayer(parent, root, bh, destructs, accounts, storage)
            self._register(layer)

    # -------------------------------------------------------------- flatten

    def flatten(self, block_hash: bytes) -> None:
        """Fold the accepted block's layer into the disk layer and drop all
        sibling branches (coreth snapshot.go Flatten)."""
        # a background generator still writing the base layer must finish
        # first: its final batch would otherwise resurrect pre-flatten
        # values over the keys folded here (and re-point SNAPSHOT_ROOT_KEY
        # at the stale root)
        self.wait_generation()
        with self.lock:
            layer = self.block_layers.get(block_hash)
            if layer is None:
                raise SnapshotError(f"cannot flatten missing layer {block_hash.hex()[:12]}")
            if isinstance(layer, DiskLayer):
                return
            if not isinstance(layer.parent(), DiskLayer):
                raise SnapshotError(
                    "flatten parent is not the disk layer (accept order violated)"
                )
            disk = layer.parent()

            batch = self.diskdb.new_batch()
            for addr_hash in layer.destructs:
                batch.delete(account_snapshot_key(addr_hash))
                self._wipe_storage(batch, addr_hash)
            for addr_hash, data in layer.accounts.items():
                if data:
                    batch.put(account_snapshot_key(addr_hash), data)
                else:
                    batch.delete(account_snapshot_key(addr_hash))
            for addr_hash, slots in layer.storage_data.items():
                for slot_hash, data in slots.items():
                    if data:
                        batch.put(storage_snapshot_key(addr_hash, slot_hash), data)
                    else:
                        batch.delete(storage_snapshot_key(addr_hash, slot_hash))
            batch.put(SNAPSHOT_ROOT_KEY, layer.root)
            batch.put(SNAPSHOT_BLOCK_HASH_KEY, layer.block_hash)
            batch.write()

            new_disk = DiskLayer(self.diskdb, layer.root, layer.block_hash)

            # drop every layer that was parented on the old disk layer except
            # the accepted branch; re-parent the accepted layer's children
            dropped = [
                l for l in self.block_layers.values()
                if isinstance(l, DiffLayer) and l.parent() is disk and l is not layer
            ]
            for l in dropped:
                self._drop_subtree(l)
            for l in list(self.block_layers.values()):
                if isinstance(l, DiffLayer) and l.parent() is layer:
                    l._parent = new_disk
            self._unregister(layer)
            self._unregister(disk)
            disk.stale = True
            layer.stale = True
            self._register(new_disk)
            self.disk_layer = new_disk

    def _drop_subtree(self, layer) -> None:
        for l in list(self.block_layers.values()):
            if isinstance(l, DiffLayer) and l.parent() is layer:
                self._drop_subtree(l)
        layer.stale = True
        self._unregister(layer)

    def _wipe_storage(self, batch, addr_hash: bytes) -> None:
        prefix = SNAPSHOT_STORAGE_PREFIX + addr_hash
        for k, _ in _flat(self.diskdb, prefix, STORAGE_KEY_LEN):
            batch.delete(k)

    # ------------------------------------------------------------- iterators

    def _layer_stack(self, root: bytes):
        """Layers from the youngest layer for [root] down to disk
        (youngest first — nearer layers shadow deeper ones)."""
        with self.lock:
            layers = self.state_layers.get(root)
            if not layers:
                raise SnapshotError(f"no snapshot for root {root.hex()}")
            layer = next(iter(layers.values()))
        stack = []
        while layer is not None:
            stack.append(layer)
            layer = layer.parent()
        return stack

    def account_iterator(self, root: bytes, start: bytes = b""):
        """Merged ascending (addr_hash, slim_rlp) across the diff stack +
        disk layer (iterator.go FastAccountIterator): the youngest layer
        wins per key; destructed/deleted accounts are skipped."""
        stack = self._layer_stack(root)

        def sources():
            for depth, layer in enumerate(stack):
                if isinstance(layer, DiskLayer):
                    layer._check()
                    pfx = SNAPSHOT_ACCOUNT_PREFIX
                    yield depth, (
                        (k[len(pfx):], v)
                        for k, v in _flat(layer.diskdb, pfx, ACCOUNT_KEY_LEN,
                                          start)
                    )
                else:
                    entries = dict.fromkeys(layer.destructs, b"")
                    entries.update(layer.accounts)
                    yield depth, iter(sorted(
                        (k, v) for k, v in entries.items() if k >= start
                    ))

        yield from _merge_sources(list(sources()))

    def storage_iterator(self, root: bytes, addr_hash: bytes,
                         start: bytes = b""):
        """Merged ascending (slot_hash, value) for one account."""
        stack = self._layer_stack(root)

        def sources():
            for depth, layer in enumerate(stack):
                if isinstance(layer, DiskLayer):
                    layer._check()
                    pfx = SNAPSHOT_STORAGE_PREFIX + addr_hash
                    yield depth, (
                        (k[len(pfx):], v)
                        for k, v in _flat(layer.diskdb, pfx, STORAGE_KEY_LEN,
                                          start)
                    )
                else:
                    slots = layer.storage_data.get(addr_hash, {})
                    yield depth, iter(sorted(
                        (k, v) for k, v in slots.items() if k >= start
                    ))
                    # a destruct truncates everything below this layer
                    if addr_hash in layer.destructs:
                        return

        yield from _merge_sources(list(sources()))

    # ------------------------------------------------------------ generation

    def _generate(self, root: bytes) -> None:
        """Build the disk layer from the state trie (generate.go, run
        synchronously; the async path wraps this in a thread)."""
        from ..metrics.spans import span

        with span("snapshot/generate", root=root.hex()[:12]):
            self._generate_inner(root)

    def _generate_inner(self, root: bytes) -> None:
        from ..trie.node import EMPTY_ROOT

        batch = self.diskdb.new_batch()
        # wipe any stale snapshot data
        for k, _ in list(_flat(self.diskdb, SNAPSHOT_ACCOUNT_PREFIX,
                               ACCOUNT_KEY_LEN)):
            batch.delete(k)
        for k, _ in list(_flat(self.diskdb, SNAPSHOT_STORAGE_PREFIX,
                               STORAGE_KEY_LEN)):
            batch.delete(k)
        if root != EMPTY_ROOT:
            from ..trie.iterator import iterate_leaves
            from .account import Account
            from .statedb import _account_to_slim

            trie = self.triedb.open_state_trie(root)
            for key_hash, value in iterate_leaves(trie.trie):
                acct = Account.decode(value)
                batch.put(account_snapshot_key(key_hash), _account_to_slim(acct))
                if acct.root != EMPTY_ROOT:
                    storage_trie = self.triedb.open_state_trie(acct.root)
                    for slot_hash, slot_val in iterate_leaves(storage_trie.trie):
                        batch.put(
                            storage_snapshot_key(key_hash, slot_hash), slot_val
                        )
        batch.put(SNAPSHOT_ROOT_KEY, root)
        batch.write()

    # --------------------------------------------------------------- verify

    def verify_root(self, root: bytes) -> bool:
        """Recompute the state root from the disk layer via a StackTrie
        (conversion.go checkAndFlatten verify path)."""
        from ..trie.stacktrie import StackTrie
        from .statedb import _slim_to_account

        st = StackTrie()
        entries = sorted(_flat(self.diskdb, SNAPSHOT_ACCOUNT_PREFIX,
                               ACCOUNT_KEY_LEN))
        for k, slim in entries:
            addr_hash = k[len(SNAPSHOT_ACCOUNT_PREFIX):]
            acct = _slim_to_account(slim)
            # rebuild the storage root from snapshot slots — verifies both
            # the account data and the flat storage against the trie root
            sst = StackTrie()
            sprefix = SNAPSHOT_STORAGE_PREFIX + addr_hash
            for sk, sval in sorted(_flat(self.diskdb, sprefix,
                                         STORAGE_KEY_LEN)):
                sst.update(sk[len(sprefix):], sval)
            rebuilt = sst.hash()
            if rebuilt != acct.root:
                return False
            st.update(addr_hash, acct.encode())
        return st.hash() == root
