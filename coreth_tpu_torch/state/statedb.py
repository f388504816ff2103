"""The block commit of a state: write the block's changed accounts into
the account trie and hash it.

Counterpart of the compositions in coreth_tpu/state/statedb.py:490-547
(StateDB.intermediate_root, without its resident branch) and :586-690
(StateDB._planned_intermediate_root, every dirty storage trie plus the
account trie in one device program). The StateDB class itself is not
ported yet, so the caller hands over the block's changed accounts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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
