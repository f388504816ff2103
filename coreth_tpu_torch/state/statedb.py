"""The planned block commit of a state: every dirty storage trie plus the
account trie in one device program.

Counterpart of the composition in coreth_tpu/state/statedb.py:586-671
(StateDB._planned_intermediate_root); the StateDB class itself is not
ported yet, so the caller hands over the block's changed accounts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..trie import planned as _planned
from ..trie.encoding import key_to_hex
from ..trie.hasher import Hasher
from ..trie.node import FullNode, ShortNode
from ..trie.planned import PlannedGraphBuilder, TooManySegments
from ..trie.secure import StateTrie
from .account import Account

Changed = Dict[bytes, Tuple[Optional[Account], Optional[StateTrie]]]


def _dirty(root) -> bool:
    return isinstance(root, (ShortNode, FullNode)) and root.flags.hash is None


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
    executor's segment table is healed and hashed on the CPU and counted in
    trie.planned.planned_fallbacks; a device error heals the holes on the
    CPU and propagates. Pass a fresh `builder` to read its plan and
    digests afterwards."""
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
        _planned.planned_fallbacks += 1
        _heal_root_holes(account_trie, patched)
        h, _ = Hasher().hash(inner.root, True)
        inner.unhashed = 0
        return bytes(h)
    except BaseException:
        # never leave zeroed storage-root holes behind a failed commit
        _heal_root_holes(account_trie, patched)
        raise
    inner.unhashed = 0
    for _addr, acct, handle, tr in patched:
        acct.root = builder.digest(handle)
        tr.trie.unhashed = 0
    return root


def _heal_root_holes(account_trie: StateTrie, patched) -> None:
    """Replace each zeroed storage-root hole with the root computed by the
    recursive CPU hasher (never the device, which may be what failed)."""
    for addr, acct, _handle, tr in patched:
        h, _ = Hasher().hash(tr.trie.root, True)
        tr.trie.unhashed = 0
        acct.root = bytes(h)
        account_trie.update(addr, acct.encode())
