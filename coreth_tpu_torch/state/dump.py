"""State dump: iterate every account under a state root, with paging.

Semantics of coreth core/state/dump.go:139 (DumpToCollector /
IteratorDump / RawDump), surfaced over RPC as debug_dumpBlock and
debug_accountRange (eth/api.go DumpBlock/AccountRange). The walk rides
trie/iterator.iterate_leaves, so paging resumes from an exact hashed
key; resident roots are handled by the caller handing in a walkable
(exported) trie — see eth/backend.walkable_state_trie. Counterpart of
coreth_tpu/state/dump.py.
"""

from __future__ import annotations

from typing import Optional

from .account import Account


def dump_accounts(state_trie, *, start: Optional[bytes] = None,
                  max_results: int = 0, storage_trie_opener=None,
                  code_getter=None, include_storage: bool = False,
                  include_code: bool = False) -> dict:
    """Walk accounts at [state_trie] in hashed-key order.

    start:        resume key (the 32-byte hashed account key), inclusive
    max_results:  page size; 0 = unbounded (dump.go's IteratorDump cap)
    storage_trie_opener(addr_hash, root) -> trie-like with .trie for
                  iterate_leaves; required when include_storage
    code_getter(code_hash) -> bytes; required when include_code

    Returns {"accounts": {hexkey: entry}, "next": hexkey|None}; entry
    keys follow the reference's DumpAccount JSON (balance, nonce, root,
    codeHash, plus address when the preimage is known).
    """
    from .. import rlp
    from ..trie.iterator import iterate_leaves

    accounts = {}
    next_key = None
    n = 0
    for hk, blob in iterate_leaves(state_trie.trie, start=start):
        if max_results and n >= max_results:
            next_key = "0x" + hk.hex()
            break
        acct = Account.decode(blob)
        entry = {
            "balance": str(acct.balance),
            "nonce": acct.nonce,
            "root": "0x" + acct.root.hex(),
            "codeHash": "0x" + acct.code_hash.hex(),
        }
        preimage = getattr(state_trie, "get_key", lambda _h: None)(hk)
        if preimage:
            entry["address"] = "0x" + preimage.hex()
        if include_code and code_getter is not None:
            code = code_getter(acct.code_hash)
            if code:
                entry["code"] = "0x" + code.hex()
        if include_storage and storage_trie_opener is not None:
            from ..trie.node import EMPTY_ROOT

            if acct.root != EMPTY_ROOT:
                st = storage_trie_opener(hk, acct.root)
                entry["storage"] = {
                    "0x" + k.hex(): "0x" + bytes(rlp.decode(v)).hex()
                    for k, v in iterate_leaves(st.trie)
                }
        accounts["0x" + hk.hex()] = entry
        n += 1
    return {"accounts": accounts, "next": next_key}
