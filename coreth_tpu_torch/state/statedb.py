"""Journaled mutable world state (semantics of coreth core/state/statedb.go);
counterpart of coreth_tpu/state/statedb.py:44-830, with the revert
closures of :857-916.

Execution mutates StateObjects through a journal (snapshot/revert); at tx
end finalise moves dirty state to pending; intermediate_root flushes
pending storage into tries and returns the root; commit persists every
dirty node into the TrieDatabase as NodeSets (storage tries, code, account
trie, TrieDatabase.update). The tries hash with the TrieDatabase's batch
keccak: the planned marker (every dirty storage trie and the account trie
in one device program, kernel K1 on CUDA), the batched marker (each trie
level by level through BatchedHasher, kernel K2 on CUDA), or None (the
recursive CPU Hasher). When the Database's backend has a resident mirror
holding the root, the account trie is a MirrorStateTrie
(state/resident_trie.py): its hash previews the block's account batch on
the mirror and commit lands it as a named block (commit(block_hash=,
parent_block_hash=)); the storage tries still hash as above, under the
planned marker in one batch_storage_roots program.

The block commit itself is composed once, by the module functions below
over a `changed` map (address -> (Account, its storage StateTrie or None);
Account None deletes the address): intermediate_root dispatches (the
resident branch of coreth_tpu/state/statedb.py:504-521 included, with its
state/hash_plan spans), and planned_intermediate_root is
StateDB._planned_intermediate_root.

With a snapshot tree (`snaps`, state/snapshot.py), account and
committed-slot reads go through the flat layer for the state's root first
(an authoritative answer, absence included) and the trie only without
one; commit records the block's diff (destructs, slim accounts, storage)
and attaches it as a diff layer, or with defer_snap=True leaves its
Tree.update arguments in `_deferred_snap_update` for the chain's insert
tail. start_prefetcher warms the touched tries while a block executes,
except on a resident account trie.

fold_tx_writes is the one way a speculative write-set reaches the StateDB
(core/parallel_exec.py, core/exec_shards.py, core/insert_pipeline.py).

Not ported (ROADMAP "Still to port", item 10): the bintrie shadow and the
expensive timers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .. import rlp
from ..core import rawdb
from ..metrics import default_registry as _metrics
from ..metrics.spans import span
from ..native import keccak256
from ..ops.device import DeviceDegradedError
from ..trie import planned as _planned
from ..trie.encoding import key_to_hex
from ..trie.hasher import BATCH_THRESHOLD, Hasher
from ..trie.node import EMPTY_ROOT, FullNode, ShortNode
from ..trie.planned import PlannedGraphBuilder, TooManySegments
from ..trie.secure import StateTrie
from ..trie.trienode import MergedNodeSet
from .access_list import AccessList
from .account import EMPTY_CODE_HASH, Account, normalize_state_key
from .database import Database
from .journal import Journal
from .log import Log
from .snapshot import SnapshotError
from .state_object import ZERO32, StateObject

# snapshot read-path attribution: a hit answered the read from the diff-
# layer stack (including authoritative absence), a miss fell back to the
# trie with snapshots configured, generating means the disk layer was
# still being built when the read arrived
_snap_hits = _metrics.counter("state/snap/hits")
_snap_misses = _metrics.counter("state/snap/misses")
_snap_generating = _metrics.counter("state/snap/generating")

Changed = Dict[bytes, Tuple[Optional[Account], Optional[StateTrie]]]


def _dirty(root) -> bool:
    return isinstance(root, (ShortNode, FullNode)) and root.flags.hash is None


def intermediate_root(account_trie: StateTrie, changed: Changed,
                      batch_keccak=None, device=None,
                      est: Optional[int] = None) -> bytes:
    """Write `changed` (address -> (Account, its storage StateTrie or None);
    Account None deletes the address) into `account_trie` and return the
    new state root, dispatching as StateDB.intermediate_root does.

    With a planned marker as `batch_keccak` and an estimate `est` of at
    least BATCH_THRESHOLD, the whole commit is one
    planned_intermediate_root. StateDB passes its pending accounts plus
    their pending storage writes; None counts the changed accounts plus
    the storage tries' unhashed updates. A resident account trie (its
    `resident` attribute set: the mirror's MirrorStateTrie) has no Python
    nodes to plan: there `est` counts the pending storage writes alone,
    and at BATCH_THRESHOLD the dirty storage tries hash in one
    batch_storage_roots program before the account writes. Otherwise each
    storage trie is hashed by its own Trie.hash, in address order, and
    then the account trie: every trie carrying the "batched" seam
    (ops/device.get_batch_keccak) and at least BATCH_THRESHOLD unhashed
    updates is hashed level by level through BatchedHasher, the rest by
    the recursive CPU Hasher. The caller gives every trie the same batch
    keccak. `device` is forwarded to the planned programs, where the
    marker's own commit decides.

    A planned program runs under the degradation ladder
    (ops/device.default_ladder). While a caller has the ladder demoted
    (BlockChain.take_over_host) the marker reads `planned` False, and a
    dispatch refused in between (DeviceDegradedError) takes the
    reference's host-routed paths, as TooManySegments does
    (coreth_tpu/state/statedb.py:549-583,598-641): the storage tries and
    the account trie hash through their own Trie.hash, whose
    BatchedHasher runs on the host batch keccak. Any error of the device
    call itself (a device fault, a BuildError) raises: the ladder never
    finishes a failed kernel on the host."""
    planned = getattr(batch_keccak, "planned", False)
    resident = getattr(account_trie, "resident", False)
    if planned and est is None:
        est = sum(tr.trie.unhashed for acct, tr in changed.values()
                  if acct is not None and tr is not None)
        if not resident:
            est += len(changed)
    if planned and est >= BATCH_THRESHOLD:
        if not resident:
            with span("state/hash_plan/planned", est=est):
                return planned_intermediate_root(
                    account_trie, changed, planned=batch_keccak.commit,
                    device=device)
        with span("state/hash_plan/storage", est=est):
            batch_storage_roots(changed, batch_keccak.commit, device)
    for addr in sorted(changed):
        acct, tr = changed[addr]
        if acct is None:
            account_trie.delete(addr)
            continue
        if tr is not None:
            acct.root = tr.hash()
        account_trie.update(addr, acct.encode())
    return account_trie.hash()


def planned_intermediate_root(account_trie: StateTrie, changed: Changed,
                              planned=None, device=None,
                              builder: Optional[PlannedGraphBuilder] = None
                              ) -> bytes:
    """Write `changed` (address -> (Account, its storage StateTrie or None);
    Account None deletes the address) into `account_trie` and return the
    new state root.

    As in StateDB._planned_intermediate_root: each account whose storage
    trie is dirty goes into the account trie with a zeroed storage-root
    hole (Account.encode_with_root_hole), keyed by the full hex path of its
    hashed address; the storage tries (add_trie) and the account trie
    (add_account_trie) then hash in one PlannedGraphBuilder.run, which
    patches each storage root into its hole on the device. On return every
    Account.root holds its storage root. A graph too large for the
    executor's segment table is counted in trie.planned.planned_fallbacks:
    each storage trie heals its hole through its own hash(), and the
    account trie through its own hash() (Trie.hash: re-planned alone, then
    BATCH_THRESHOLD), as coreth_tpu/state/statedb.py:641-665 does; so is
    a dispatch the degradation ladder refused (DeviceDegradedError: a
    caller demoted it; not counted there), whose tries then hash on the
    host. Any other error
    heals the holes on the recursive CPU Hasher and propagates. Pass a
    fresh `builder` to read its plan and digests afterwards."""
    builder = builder if builder is not None else PlannedGraphBuilder()
    holes = {}
    patched: List[Tuple[bytes, Account, object, StateTrie]] = []
    for addr in sorted(changed):
        acct, tr = changed[addr]
        if acct is None:
            account_trie.delete(addr)
            continue
        if tr is not None and _dirty(tr.trie.root):
            handle = builder.add_trie(tr.trie.root)
            enc, off = acct.encode_with_root_hole()
            account_trie.update(addr, enc)
            holes[key_to_hex(account_trie.hash_key(addr))] = (off, handle)
            patched.append((addr, acct, handle, tr))
        else:
            if tr is not None:
                acct.root = tr.hash()
            account_trie.update(addr, acct.encode())

    inner = account_trie.trie
    if not _dirty(inner.root):
        # nothing to plan: heal any hole and hash as Trie.hash does
        _heal_root_holes(account_trie, patched, force_cpu=False)
        return account_trie.hash()
    builder.add_account_trie(inner.root, holes)
    try:
        root = builder.run(planned, device)
    except (TooManySegments, DeviceDegradedError) as e:
        # heal each hole with its trie's own hash(), then hash the account
        # trie through its own Trie.hash, which re-plans it alone and
        # falls back to BatchedHasher in turn (host-routed once demoted)
        if isinstance(e, TooManySegments):
            _planned.planned_fallbacks += 1
        _heal_root_holes(account_trie, patched, force_cpu=False)
        return account_trie.hash()
    except BaseException:
        # never leave zeroed storage-root holes behind a failed commit
        _heal_root_holes(account_trie, patched, force_cpu=True)
        raise
    inner.unhashed = 0
    for _addr, acct, handle, tr in patched:
        acct.root = builder.digest(handle)
        tr.trie.unhashed = 0
    return root


def _heal_root_holes(account_trie: StateTrie, patched,
                     force_cpu: bool) -> None:
    """Replace each zeroed storage-root hole with its trie's real root.
    force_cpu takes the recursive CPU Hasher and never the device, which
    may be what just failed; otherwise each storage trie's own hash()."""
    for addr, acct, _handle, tr in patched:
        if force_cpu:
            h, _ = Hasher().hash(tr.trie.root, True)
            tr.trie.unhashed = 0
            acct.root = bytes(h)
        else:
            acct.root = tr.hash()
        account_trie.update(addr, acct.encode())


def batch_storage_roots(changed: Changed, planned=None, device=None) -> int:
    """One planned program over every dirty storage trie in `changed` and
    no account trie (StateDB._batch_storage_roots): on success each trie's
    nodes carry their hashes and its Account.root is the trie's root, so a
    later tr.hash() is a cache hit. `planned` is the PlannedCommit to run
    (else the default one of `device`: None is CUDA). A graph too large for
    the segment table (TooManySegments), or a dispatch the degradation
    ladder refused (DeviceDegradedError: a caller demoted it), leaves every trie untouched for
    its own hash() (host-routed once demoted); there are no holes to
    heal. Returns the tries hashed."""
    builder = PlannedGraphBuilder()
    pending = []
    for addr in sorted(changed):
        acct, tr = changed[addr]
        if acct is not None and tr is not None and _dirty(tr.trie.root):
            pending.append((acct, builder.add_trie(tr.trie.root), tr))
    if not pending:
        return 0
    try:
        builder.run(planned, device)
    except (TooManySegments, DeviceDegradedError):
        return 0
    for acct, handle, tr in pending:
        acct.root = builder.digest(handle)
        tr.trie.unhashed = 0
    return len(pending)


class StateDB:
    """The journaled state over one root of a state Database. Its tries
    hash with the batch keccak of the Database's TrieDatabase; `snaps` is
    the flat snapshot tree its reads go through first (module
    docstring)."""

    def __init__(self, root: bytes, db: Database, snaps=None):
        self.db = db
        self.original_root = root
        self.trie = db.open_trie(root)
        self.journal = Journal()

        self._objects: Dict[bytes, StateObject] = {}
        self._objects_pending: Set[bytes] = set()
        self._objects_dirty: Set[bytes] = set()

        self.refund = 0
        self.this_tx_hash = b"\x00" * 32
        self.tx_index = 0
        self.logs: Dict[bytes, List[Log]] = {}
        self.log_size = 0
        self.preimages: Dict[bytes, bytes] = {}

        self.access_list = AccessList()
        self.transient: Dict[Tuple[bytes, bytes], bytes] = {}

        # concurrent trie warmer (core/state/trie_prefetcher.go seam)
        self.prefetcher = None

        # flat snapshot tree; when set, reads go through it first
        self.snaps = snaps
        self.snap = snaps.snapshot(root) if snaps is not None else None
        self._snap_destructs: Set[bytes] = set()
        self._snap_accounts: Dict[bytes, bytes] = {}
        self._snap_storage: Dict[bytes, Dict[bytes, bytes]] = {}
        # Tree.update args stashed by commit(defer_snap=True) for the
        # chain's insert-tail worker
        self._deferred_snap_update = None

    # ------------------------------------------------------------ object mgmt

    def _get_state_object(self, addr: bytes) -> Optional[StateObject]:
        obj = self._get_deleted_state_object(addr)
        if obj is not None and obj.deleted:
            return None
        return obj

    def _get_deleted_state_object(self, addr: bytes) -> Optional[StateObject]:
        """Like _get_state_object but returns deleted-marked objects too
        (getDeletedStateObject, statedb.go), so that recreate-after-suicide
        journals a reset, not a create."""
        obj = self._objects.get(addr)
        if obj is not None:
            return obj
        return self._load_state_object(addr)

    def start_prefetcher(self, namespace: str = "chain") -> None:
        """StartPrefetcher (statedb.go): warm touched tries concurrently."""
        from .trie_prefetcher import TriePrefetcher

        self.stop_prefetcher()
        if getattr(self.trie, "resident", False):
            # resident account reads are O(path) native lookups with no
            # triedb cache to warm; a prefetcher would only add threads
            return
        self.prefetcher = TriePrefetcher(self.db, namespace)

    def stop_prefetcher(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None

    def _load_state_object(self, addr: bytes) -> Optional[StateObject]:
        acct = None
        addr_hash = keccak256(addr)
        if self.prefetcher is not None:
            self.prefetcher.prefetch(b"", self.original_root, [addr])
        if self.snap is not None:
            slim = None
            for attempt in (0, 1):
                try:
                    slim = self.snap.account(addr_hash)
                    break
                except SnapshotError as exc:
                    self.snap = self._reresolve_snap(attempt, exc)
                    if self.snap is None:
                        break
            if self.snap is not None:
                # the snapshot answer is authoritative (snapshot.go: the
                # disk layer IS the flat state): None means the account
                # does not exist — no trie fallback
                _snap_hits.inc()
                if not slim:
                    return None
                acct = _slim_to_account(slim)
        if acct is None:
            if self.snaps is not None and self.snap is None:
                _snap_misses.inc()
            blob = self.trie.get(addr)
            if not blob:
                return None
            acct = Account.decode(blob)
        obj = StateObject(self, addr, acct)
        self._objects[addr] = obj
        return obj

    def _reresolve_snap(self, attempt: int, exc: Exception):
        """A SnapshotError mid-read means generation is still running, or
        an Accept flattened our layer under us. The flattened case is
        recoverable: the same state now lives in the new disk layer, so
        look the root up again (once) instead of abandoning the fast
        path — dropping it would also skip this block's diff-layer
        registration at commit and break the Accept that follows."""
        generating = "generation in progress" in str(exc)
        if attempt == 0 and self.snaps is not None and not generating:
            snap = self.snaps.snapshot(self.original_root)
            if snap is not None:
                return snap
        if generating:
            _snap_generating.inc()
        else:
            _snap_misses.inc()
        return None

    def snapshot_storage(self, addr_hash: bytes, key: bytes) -> Optional[bytes]:
        """Flat-snapshot storage read hook used by StateObject: the
        32-byte value, or None when there is no snapshot to ask."""
        if self.snap is None:
            if self.snaps is not None:
                _snap_misses.inc()
            return None
        raw = None
        for attempt in (0, 1):
            try:
                raw = self.snap.storage(addr_hash, keccak256(key))
                break
            except SnapshotError as exc:
                self.snap = self._reresolve_snap(attempt, exc)
                if self.snap is None:
                    return None
        _snap_hits.inc()
        if not raw:
            # authoritative absence: the slot was never written (or was
            # deleted) — zero, with no trie walk
            return ZERO32
        return rlp.decode(raw).rjust(32, b"\x00")

    def _get_or_new(self, addr: bytes) -> StateObject:
        obj = self._get_state_object(addr)
        if obj is None:
            obj, _ = self._create_object(addr)
        return obj

    def _create_object(self, addr: bytes):
        prev = self._get_deleted_state_object(addr)
        obj = StateObject(self, addr, None)
        if prev is None:
            self.journal.append(_revert_create(addr), addr)
        else:
            self.journal.append(_revert_reset(addr, prev), addr)
        self._objects[addr] = obj
        return obj, prev

    def create_account(self, addr: bytes) -> None:
        """EIP-684/CREATE semantics: new object, balance carried over."""
        new, prev = self._create_object(addr)
        if prev is not None:
            new.set_balance(prev.data.balance)

    def exist(self, addr: bytes) -> bool:
        return self._get_state_object(addr) is not None

    def empty(self, addr: bytes) -> bool:
        obj = self._get_state_object(addr)
        return obj is None or obj.empty

    # ---------------------------------------------------------------- reads

    def get_balance(self, addr: bytes) -> int:
        obj = self._get_state_object(addr)
        return obj.data.balance if obj else 0

    def get_balance_multicoin(self, addr: bytes, coin_id: bytes) -> int:
        obj = self._get_state_object(addr)
        return obj.balance_multicoin(coin_id) if obj else 0

    def get_nonce(self, addr: bytes) -> int:
        obj = self._get_state_object(addr)
        return obj.data.nonce if obj else 0

    def get_code(self, addr: bytes) -> bytes:
        obj = self._get_state_object(addr)
        return obj.get_code() if obj else b""

    def get_code_size(self, addr: bytes) -> int:
        return len(self.get_code(addr))

    def get_code_hash(self, addr: bytes) -> bytes:
        obj = self._get_state_object(addr)
        return obj.data.code_hash if obj else b"\x00" * 32

    def get_state(self, addr: bytes, key: bytes) -> bytes:
        obj = self._get_state_object(addr)
        if obj is None:
            return ZERO32
        return obj.get_state(normalize_state_key(key))

    def get_committed_state(self, addr: bytes, key: bytes) -> bytes:
        obj = self._get_state_object(addr)
        if obj is None:
            return ZERO32
        return obj.get_committed_state(normalize_state_key(key))

    def has_suicided(self, addr: bytes) -> bool:
        obj = self._get_state_object(addr)
        return obj.suicided if obj else False

    # --------------------------------------------------------------- writes

    def add_balance(self, addr: bytes, amount: int) -> None:
        self._get_or_new(addr).add_balance(amount)

    def sub_balance(self, addr: bytes, amount: int) -> None:
        self._get_or_new(addr).sub_balance(amount)

    def set_balance(self, addr: bytes, amount: int) -> None:
        self._get_or_new(addr).set_balance(amount)

    def add_balance_multicoin(self, addr: bytes, coin_id: bytes, amount: int) -> None:
        self._get_or_new(addr).add_balance_multicoin(coin_id, amount)

    def sub_balance_multicoin(self, addr: bytes, coin_id: bytes, amount: int) -> None:
        self._get_or_new(addr).sub_balance_multicoin(coin_id, amount)

    def set_nonce(self, addr: bytes, nonce: int) -> None:
        self._get_or_new(addr).set_nonce(nonce)

    def set_code(self, addr: bytes, code: bytes) -> None:
        self._get_or_new(addr).set_code(keccak256(code), code)

    def set_state(self, addr: bytes, key: bytes, value: bytes) -> None:
        self._get_or_new(addr).set_state(normalize_state_key(key), value)

    def suicide(self, addr: bytes) -> bool:
        obj = self._get_state_object(addr)
        if obj is None:
            return False
        self.journal.append(
            _revert_suicide(addr, obj.suicided, obj.data.balance), addr
        )
        obj.mark_suicided()
        obj.data.balance = 0
        return True

    # ---------------------------------------------------- transient (1153)

    def get_transient_state(self, addr: bytes, key: bytes) -> bytes:
        return self.transient.get((addr, key), ZERO32)

    def set_transient_state(self, addr: bytes, key: bytes, value: bytes) -> None:
        prev = self.get_transient_state(addr, key)
        if prev == value:
            return
        self.journal.append(_revert_transient(addr, key, prev))
        self.transient[(addr, key)] = value

    # -------------------------------------------------------------- refunds

    def get_refund(self) -> int:
        return self.refund

    def add_refund(self, gas: int) -> None:
        prev = self.refund
        self.journal.append(_revert_refund(prev))
        self.refund += gas

    def sub_refund(self, gas: int) -> None:
        prev = self.refund
        if gas > self.refund:
            raise ValueError(f"refund counter below zero ({self.refund} < {gas})")
        self.journal.append(_revert_refund(prev))
        self.refund -= gas

    # ----------------------------------------------------------------- logs

    def add_log(self, log: Log) -> None:
        self.journal.append(_revert_log(self.this_tx_hash))
        log.tx_hash = self.this_tx_hash
        log.tx_index = self.tx_index
        log.index = self.log_size
        self.logs.setdefault(self.this_tx_hash, []).append(log)
        self.log_size += 1

    def get_logs(self, tx_hash: bytes, block_number: int, block_hash: bytes):
        logs = self.logs.get(tx_hash, [])
        for l in logs:
            l.block_number = block_number
            l.block_hash = block_hash
        return logs

    def add_preimage(self, hash_: bytes, preimage: bytes) -> None:
        if hash_ not in self.preimages:
            self.journal.append(_revert_preimage(hash_))
            self.preimages[hash_] = preimage

    # ------------------------------------------------------ tx context setup

    def set_tx_context(self, tx_hash: bytes, tx_index: int) -> None:
        self.this_tx_hash = tx_hash
        self.tx_index = tx_index

    def prepare(self, rules, sender, coinbase, dst, precompiles, tx_access_list):
        """EIP-2929/2930/3651 warm-up (statedb.go Prepare)."""
        if getattr(rules, "is_berlin", True):
            self.access_list = AccessList()
            self.access_list.add_address(sender)
            if dst is not None:
                self.access_list.add_address(dst)
            for addr in precompiles:
                self.access_list.add_address(addr)
            if tx_access_list:
                for addr, keys in tx_access_list:
                    self.access_list.add_address(addr)
                    for k in keys:
                        self.access_list.add_slot(addr, k)
            if getattr(rules, "is_shanghai", False) or getattr(rules, "is_d_upgrade", False):
                self.access_list.add_address(coinbase)
        self.transient = {}

    def address_in_access_list(self, addr: bytes) -> bool:
        return self.access_list.contains_address(addr)

    def slot_in_access_list(self, addr: bytes, slot: bytes):
        return self.access_list.contains(addr, slot)

    def add_address_to_access_list(self, addr: bytes) -> None:
        if self.access_list.add_address(addr):
            self.journal.append(_revert_access_address(addr))

    def add_slot_to_access_list(self, addr: bytes, slot: bytes) -> None:
        addr_added, slot_added = self.access_list.add_slot(addr, slot)
        if addr_added:
            self.journal.append(_revert_access_address(addr))
        if slot_added:
            self.journal.append(_revert_access_slot(addr, slot))

    # ----------------------------------------------------- snapshot machinery

    def snapshot(self) -> int:
        return self.journal.length()

    def revert_to_snapshot(self, snap_id: int) -> None:
        self.journal.revert(self, snap_id)

    # --------------------------------------------------- finalise/root/commit

    def finalise(self, delete_empty: bool) -> None:
        """Tx-end pass (statedb.go:903): fold journal dirties into pending."""
        for addr in list(self.journal.dirties):
            obj = self._objects.get(addr)
            if obj is None:
                continue
            if obj.suicided or (delete_empty and obj.empty):
                obj.deleted = True
                self._snap_destructs.add(obj.addr_hash)
                self._snap_accounts.pop(obj.addr_hash, None)
                self._snap_storage.pop(obj.addr_hash, None)
            else:
                obj.finalise()
            self._objects_pending.add(addr)
            self._objects_dirty.add(addr)
        self.journal = Journal()
        self.refund = 0

    def fold_tx_writes(self, tx_hash: bytes, tx_index: int, accounts,
                       storage, logs, preimages,
                       fee_to: Optional[bytes] = None,
                       fee_amount: int = 0) -> None:
        """Deterministic-commit entry point of the speculative executors
        (core/parallel_exec.py): apply one transaction's validated
        write-set straight into pending state, called in ascending
        tx-index order, reproducing what the journaled execute +
        finalise(True) pair leaves behind.

        `accounts` maps addr -> account tuple (nonce, balance, code_hash,
        code, code_dirty, is_multi_coin, fresh) or None for a deletion
        (suicide or EIP-158 empty); `storage` maps (addr, normalized key)
        -> value for live accounts; `fee_to`/`fee_amount` carry the
        commutative coinbase fee delta. Assumes an empty journal: the
        executor finalises the configure-precompiles writes before the
        first fold."""
        self.set_tx_context(tx_hash, tx_index)
        for addr, ws in accounts.items():  # write-set order == journal.dirties order
            if ws is None:
                obj = self._get_deleted_state_object(addr)
                if obj is None:
                    # created and destructed within this tx: a bare object
                    # carries the deletion marker (serial leaves the same)
                    obj = StateObject(self, addr, None)
                    self._objects[addr] = obj
                obj.deleted = True
                self._snap_destructs.add(obj.addr_hash)
                self._snap_accounts.pop(obj.addr_hash, None)
                self._snap_storage.pop(obj.addr_hash, None)
            else:
                (nonce, balance, code_hash, code, code_dirty, is_multi_coin,
                 fresh) = ws
                obj = self._get_state_object(addr)
                if obj is None or fresh:
                    # (re)created this tx: empty storage root, like the
                    # serial _create_object reset
                    obj = StateObject(self, addr, None)
                    self._objects[addr] = obj
                d = obj.data
                d.nonce = nonce
                d.balance = balance
                d.is_multi_coin = is_multi_coin
                if code_dirty:
                    obj.code = code
                    d.code_hash = code_hash
                    obj.dirty_code = True
            self._objects_pending.add(addr)
            self._objects_dirty.add(addr)
        for (addr, key), value in storage.items():
            self._objects[addr].pending_storage[key] = value
        if fee_amount:
            obj = self._get_state_object(fee_to)
            if obj is None:
                obj = StateObject(self, fee_to, None)
                self._objects[fee_to] = obj
            obj.data.balance += fee_amount
            self._objects_pending.add(fee_to)
            self._objects_dirty.add(fee_to)
        for log in logs:
            log.tx_hash = tx_hash
            log.tx_index = tx_index
            log.index = self.log_size
            self.logs.setdefault(tx_hash, []).append(log)
            self.log_size += 1
        for h, p in preimages.items():
            if h not in self.preimages:
                self.preimages[h] = p
        self.refund = 0

    def _pending_changes(self) -> Changed:
        """The pending objects as a `changed` map, in address order, each
        live object's pending storage flushed into its storage trie."""
        changed: Changed = {}
        for addr in sorted(self._objects_pending):
            obj = self._objects[addr]
            changed[addr] = ((None, None) if obj.deleted
                             else (obj.data, obj.update_trie()))
        return changed

    def intermediate_root(self, delete_empty: bool) -> bytes:
        """Hash the state trie after flushing pending (statedb.go:952).

        Under the planned marker, with at least BATCH_THRESHOLD pending
        accounts plus their pending storage writes, every dirty storage
        trie and the account trie hash in one device program (the
        module's planned_intermediate_root, which is the reference's
        _planned_intermediate_root with its TooManySegments heal);
        otherwise each trie's own Trie.hash. On a resident account trie
        the pending storage writes alone count, and reaching the threshold
        hashes the storage tries in one program; the account writes then
        go into the MirrorStateTrie, whose hash() previews them on the
        mirror. The module's intermediate_root makes that choice."""
        self.finalise(delete_empty)
        est = sum(
            len(self._objects[a].pending_storage)
            for a in self._objects_pending
            if not self._objects[a].deleted
        )
        if not getattr(self.trie, "resident", False):
            est += len(self._objects_pending)
        changed = self._pending_changes()
        self._objects_pending = set()
        root = intermediate_root(self.trie, changed,
                                 self.db.triedb.batch_keccak, est=est)
        if self.snap is not None:
            # the accounts' storage roots are final only now
            for addr, (acct, _tr) in changed.items():
                if acct is not None:
                    self._snap_accounts[self._objects[addr].addr_hash] = \
                        _account_to_slim(acct)
        return root

    def commit(self, delete_empty: bool = False,
               block_hash: Optional[bytes] = None,
               parent_block_hash: Optional[bytes] = None,
               defer_snap: bool = False) -> bytes:
        """Commit to the TrieDatabase (statedb.go:1040-1160).

        Order: storage tries → code → account trie → TrieDB.Update.
        Returns the new state root. On a resident account trie the mirror
        records the block's state under `block_hash` on top of
        `parent_block_hash` (MirrorStateTrie.commit_block: a preview when
        block_hash is None); its nodes persist through the writer's
        interval export, not the dirty forest, and a node set comes back
        only on the disk-fallback path of a mirror in host mode.

        With a snapshot tree, the block's diff becomes a diff layer keyed
        by `block_hash` on top of `parent_block_hash`'s; defer_snap=True
        stashes the Tree.update arguments as `_deferred_snap_update`
        instead, and the caller applies them before anyone opens a
        StateDB on the new root (the chain's insert tail)."""
        self.intermediate_root(delete_empty)
        merged = MergedNodeSet()
        for addr in sorted(self._objects_dirty):
            obj = self._objects[addr]
            if obj.deleted:
                continue
            if obj.dirty_code:
                rawdb.write_code(self.db.diskdb, obj.data.code_hash, obj.code)
                obj.dirty_code = False
            nodeset = obj.commit_trie()
            if nodeset is not None:
                nodeset.owner = obj.addr_hash
                merged.merge(nodeset)
            if self.snap is not None and obj.snap_flush:
                stor = self._snap_storage.setdefault(obj.addr_hash, {})
                for k, v in obj.snap_flush.items():
                    stor[keccak256(k)] = (rlp.encode(v.lstrip(b"\x00"))
                                          if v != ZERO32 else b"")
            obj.snap_flush = {}
        if getattr(self.trie, "resident", False):
            root, acct_set = self.trie.commit_block(block_hash,
                                                    parent_block_hash)
        else:
            root, acct_set = self.trie.commit(collect_leaf=True)
        if acct_set is not None:
            merged.merge(acct_set)
        self._objects_dirty = set()
        if root != self.original_root and merged.sets:
            self.db.triedb.update(root, self.original_root, merged)
        self._deferred_snap_update = None
        if self.snaps is not None and self.snap is not None:
            # identical-root blocks still need their (empty) diff layer:
            # Avalanche blocks are keyed by hash, and Accept will flatten
            # this block_hash (coreth snapshot.go blockLayers semantics)
            if root != self.original_root or block_hash is not None:
                update_args = (root, self.original_root,
                               self._snap_destructs, self._snap_accounts,
                               self._snap_storage, block_hash,
                               parent_block_hash)
                if defer_snap:
                    self._deferred_snap_update = update_args
                else:
                    self.snaps.update(*update_args)
            self._snap_destructs, self._snap_accounts, self._snap_storage = (
                set(), {}, {})
            self.snap = self.snaps.snapshot(root)
        # subsequent commits diff against the new root (geth statedb.Commit);
        # our Trie freezes after commit, so reopen it from the forest
        self.original_root = root
        self.trie = self.db.open_trie(root)
        return root

    def copy(self) -> "StateDB":
        s = StateDB.__new__(StateDB)
        s.db = self.db
        s.original_root = self.original_root
        s.trie = self.trie.copy()
        s.journal = Journal()
        s._objects = {a: o.copy(s) for a, o in self._objects.items()}
        # fold in-flight journal dirties into the copy's pending/dirty sets:
        # the copy has an empty journal, so without this a mid-tx copy would
        # lose the current tx's mutations at root computation (geth Copy)
        s._objects_pending = set(self._objects_pending) | set(self.journal.dirties)
        s._objects_dirty = set(self._objects_dirty) | set(self.journal.dirties)
        s.refund = self.refund
        s.this_tx_hash = self.this_tx_hash
        s.tx_index = self.tx_index
        s.logs = {h: list(ls) for h, ls in self.logs.items()}
        s.log_size = self.log_size
        s.preimages = dict(self.preimages)
        s.access_list = self.access_list.copy()
        s.transient = dict(self.transient)
        # the copy never inherits the prefetcher: it is tied to the parent's
        # lifecycle (geth statedb.Copy drops it the same way)
        s.prefetcher = None
        s.snaps = self.snaps
        s.snap = self.snap
        s._snap_destructs = set(self._snap_destructs)
        s._snap_accounts = dict(self._snap_accounts)
        s._snap_storage = {k: dict(v) for k, v in self._snap_storage.items()}
        s._deferred_snap_update = None
        return s


# --- slim snapshot account codec (core/state/snapshot/account.go) ----------

def _account_to_slim(acct: Account) -> bytes:
    root = b"" if acct.root == EMPTY_ROOT else acct.root
    code = b"" if acct.code_hash == EMPTY_CODE_HASH else acct.code_hash
    return rlp.encode(
        [acct.nonce, acct.balance, root, code, 1 if acct.is_multi_coin else 0]
    )


def _slim_to_account(blob: bytes) -> Account:
    items = rlp.decode(blob)
    root = items[2] if items[2] else EMPTY_ROOT
    code = items[3] if items[3] else EMPTY_CODE_HASH
    return Account(
        nonce=rlp.decode_uint(items[0]),
        balance=rlp.decode_uint(items[1]),
        root=root,
        code_hash=code,
        is_multi_coin=rlp.decode_uint(items[4]) != 0,
    )


# --- journal closures for StateDB-level state -------------------------------

def _revert_create(addr):
    def rev(db):
        db._objects.pop(addr, None)
    return rev


def _revert_reset(addr, prev):
    def rev(db):
        db._objects[addr] = prev
    return rev


def _revert_suicide(addr, prev_suicided, prev_balance):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.suicided = prev_suicided
            obj.data.balance = prev_balance
    return rev


def _revert_transient(addr, key, prev):
    def rev(db):
        db.transient[(addr, key)] = prev
    return rev


def _revert_refund(prev):
    def rev(db):
        db.refund = prev
    return rev


def _revert_log(tx_hash):
    def rev(db):
        logs = db.logs.get(tx_hash)
        if logs:
            logs.pop()
            if not logs:
                del db.logs[tx_hash]
        db.log_size -= 1
    return rev


def _revert_preimage(hash_):
    def rev(db):
        db.preimages.pop(hash_, None)
    return rev


def _revert_access_address(addr):
    def rev(db):
        db.access_list.delete_address(addr)
    return rev


def _revert_access_slot(addr, slot):
    def rev(db):
        db.access_list.delete_slot(addr, slot)
    return rev
