"""The block commit of a state: write the block's changed accounts into
the account trie and hash it.

Counterpart of the compositions in coreth_tpu/state/statedb.py:490-547
(StateDB.intermediate_root: the default dispatch in `intermediate_root`,
its resident branch in `resident_intermediate_root`), :549-584
(StateDB._batch_storage_roots: `batch_storage_roots`) and :586-690
(StateDB._planned_intermediate_root, every dirty storage trie plus the
account trie in one device program). The StateDB class itself is not
ported yet, so the caller hands over the block's changed accounts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..device import resolve
from ..native import keccak256
from ..trie import planned as _planned
from ..trie.encoding import key_to_hex
from ..trie.hasher import BATCH_THRESHOLD, Hasher
from ..trie.node import FullNode, ShortNode
from ..trie.planned import PlannedGraphBuilder, TooManySegments
from ..trie.secure import StateTrie
from .account import Account

Changed = Dict[bytes, Tuple[Optional[Account], Optional[StateTrie]]]


def _dirty(root) -> bool:
    return isinstance(root, (ShortNode, FullNode)) and root.flags.hash is None


def intermediate_root(account_trie: StateTrie, changed: Changed,
                      batch_keccak=None, device=None) -> bytes:
    """Write `changed` (address -> (Account, its storage StateTrie or None);
    Account None deletes the address) into `account_trie` and return the
    new state root, dispatching as StateDB.intermediate_root does.

    With a planned marker as `batch_keccak` and at least BATCH_THRESHOLD
    changed accounts plus pending storage writes, the whole commit is one
    planned_intermediate_root. Otherwise each storage trie is hashed by its
    own Trie.hash, in address order, and then the account trie: every trie
    carrying the "batched" seam (ops/device.get_batch_keccak) and at least
    BATCH_THRESHOLD unhashed updates is hashed level by level through
    BatchedHasher, the rest by the recursive CPU Hasher. The caller gives
    every trie the same batch keccak. `device` is forwarded to
    planned_intermediate_root, where the marker's own commit decides."""
    if getattr(batch_keccak, "planned", False):
        est = len(changed) + sum(tr.trie.unhashed
                                 for acct, tr in changed.values()
                                 if acct is not None and tr is not None)
        if est >= BATCH_THRESHOLD:
            return planned_intermediate_root(
                account_trie, changed, planned=batch_keccak.commit,
                device=device)
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
    BatchedHasher if that overflows too, or the CPU Hasher below
    BATCH_THRESHOLD), as coreth_tpu/state/statedb.py:641-665 does. A device
    error heals the holes on the recursive CPU Hasher and propagates. Pass
    a fresh `builder` to read its plan and digests afterwards."""
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
        return account_trie.hash()
    builder.add_account_trie(inner.root, holes)
    try:
        root = builder.run(planned, device)
    except TooManySegments:
        # heal each hole with its trie's own hash(), then hash the account
        # trie through its own Trie.hash, which re-plans it alone and
        # falls back to BatchedHasher in turn
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
    the segment table (TooManySegments) leaves every trie untouched for its
    own hash(); there are no holes to heal. Returns the tries hashed."""
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
    except TooManySegments:
        return 0
    for acct, handle, tr in pending:
        acct.root = builder.digest(handle)
        tr.trie.unhashed = 0
    return len(pending)


def resident_items(changed: Changed, planned=None, device=None) -> list:
    """The account trie's updates for `changed`, as the resident branch of
    StateDB.intermediate_root writes them: the storage roots first (in one
    batch_storage_roots program when the pending storage writes reach
    BATCH_THRESHOLD, else each trie's own hash()), then (keccak(address),
    account RLP) per address in address order, an empty value deleting."""
    est = sum(tr.trie.unhashed for acct, tr in changed.values()
              if acct is not None and tr is not None)
    if est >= BATCH_THRESHOLD:
        batch_storage_roots(changed, planned, device)
    items = []
    for addr in sorted(changed):
        acct, tr = changed[addr]
        if acct is None:
            items.append((keccak256(addr), b""))
            continue
        if tr is not None:
            acct.root = tr.hash()
        items.append((keccak256(addr), acct.encode()))
    return items


def resident_intermediate_root(inc_trie, executor, changed: Changed, *,
                               template: bool = False, device=None) -> bytes:
    """The resident branch of StateDB.intermediate_root: the block's
    storage roots (resident_items), then each changed account written into
    the native account trie `inc_trie` (native.mpt.IncrementalTrie), then
    one device-resident commit through `executor`
    (ops.keccak_resident.ResidentExecutor): commit_resident, or
    commit_template when `template`. Returns the 32-byte state root.

    `device` (None is CUDA, and raises without it) runs the storage
    program and must be the executor's device."""
    dev = resolve(device)
    if executor.device != dev:
        raise ValueError(f"executor runs on {executor.device}, not {dev}")
    inc_trie.update(resident_items(changed, device=dev))
    if template:
        return inc_trie.commit_template(executor)
    return executor.root_bytes(inc_trie.commit_resident(executor))
