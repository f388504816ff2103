"""Per-account mutable state (semantics of coreth core/state/state_object.go);
counterpart of coreth_tpu/state/state_object.py.

A stateObject carries the account data plus three storage maps:
  origin_storage  — values as of the start of the tx (cache of trie reads)
  pending_storage — values finalised at tx end, flushed to the trie at
                    IntermediateRoot/Commit
  dirty_storage   — values modified in the current tx

Storage values are 32-byte words; zero deletes. The storage trie encodes
values RLP-trimmed (leading zeros stripped) exactly like the reference.
Committed-slot reads go through the StateDB's flat snapshot first
(StateDB.snapshot_storage), and every slot written to the trie since the
last commit is recorded in snap_flush, the snapshot diff's source.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import rlp
from ..native import keccak256
from .account import EMPTY_CODE_HASH, Account, normalize_coin_id

RIPEMD_ADDR = (b"\x00" * 19) + b"\x03"  # journal.go touchChange special case

ZERO32 = b"\x00" * 32


def _trim32(value: bytes) -> bytes:
    return value.lstrip(b"\x00")


def _pad32(value: bytes) -> bytes:
    return value.rjust(32, b"\x00")


class StateObject:
    def __init__(self, db, address: bytes, account: Optional[Account] = None):
        self._db = db  # owning StateDB
        self.address = address
        self.addr_hash = keccak256(address)
        self.data = account.copy() if account else Account()
        self.origin: Optional[Account] = account.copy() if account else None

        self.code: Optional[bytes] = None
        self.dirty_code = False
        self.suicided = False
        self.deleted = False

        self.origin_storage: Dict[bytes, bytes] = {}
        self.pending_storage: Dict[bytes, bytes] = {}
        self.dirty_storage: Dict[bytes, bytes] = {}
        # slots actually written to the trie since the last commit — the
        # flat-snapshot diff source (not origin_storage, which also caches
        # slots that were merely read)
        self.snap_flush: Dict[bytes, bytes] = {}

        self._trie = None  # lazily opened storage trie

    # ------------------------------------------------------------- metadata

    @property
    def empty(self) -> bool:
        return self.data.empty

    def mark_suicided(self) -> None:
        self.suicided = True

    # --------------------------------------------------------------- trie

    def _open_trie(self):
        if self._trie is None:
            self._trie = self._db.db.open_storage_trie(
                self.addr_hash, self.data.root
            )
        return self._trie

    # ------------------------------------------------------------- storage

    def get_state(self, key: bytes) -> bytes:
        v = self.dirty_storage.get(key)
        if v is not None:
            return v
        return self.get_committed_state(key)

    def get_committed_state(self, key: bytes) -> bytes:
        v = self.pending_storage.get(key)
        if v is not None:
            return v
        v = self.origin_storage.get(key)
        if v is not None:
            return v
        # snapshot fast path, else trie
        snap_val = self._db.snapshot_storage(self.addr_hash, key)
        if snap_val is not None:
            value = snap_val
        else:
            enc = self._open_trie().get(key)
            value = _pad32(rlp.decode(enc)) if enc else ZERO32
        self.origin_storage[key] = value
        return value

    def set_state(self, key: bytes, value: bytes) -> None:
        prev = self.get_state(key)
        if prev == value:
            return
        self._db.journal.append(
            _revert_storage(self.address, key, prev), self.address
        )
        self.dirty_storage[key] = value

    def finalise(self) -> None:
        """Move dirty storage into pending at tx end (state_object.go:140)."""
        for k, v in self.dirty_storage.items():
            self.pending_storage[k] = v
        if self.dirty_storage:
            self.dirty_storage = {}

    def update_trie(self):
        """Flush pending storage into the storage trie; returns the trie."""
        self.finalise()
        if not self.pending_storage:
            return self._trie
        tr = self._open_trie()
        for k, v in self.pending_storage.items():
            if self.origin_storage.get(k) == v:
                continue
            self.origin_storage[k] = v
            self.snap_flush[k] = v
            if v == ZERO32:
                tr.delete(k)
            else:
                tr.update(k, rlp.encode(_trim32(v)))
        self.pending_storage = {}
        return tr

    def update_root(self) -> None:
        """Recompute data.root from pending storage (hash only, no commit)."""
        tr = self.update_trie()
        if tr is not None:
            self.data.root = tr.hash()

    def commit_trie(self):
        """Commit the storage trie; returns (nodeset or None)."""
        tr = self.update_trie()
        if tr is None:
            return None
        root, nodeset = tr.commit(collect_leaf=False)
        self.data.root = root
        self._trie = None  # committed tries reject writes; reopen lazily
        return nodeset

    # ------------------------------------------------------------- balance

    def add_balance(self, amount: int) -> None:
        if amount == 0:
            # still touch: matters for empty-account deletion (EIP-158)
            if self.empty:
                self.touch()
            return
        self.set_balance(self.data.balance + amount)

    def sub_balance(self, amount: int) -> None:
        if amount == 0:
            return
        self.set_balance(self.data.balance - amount)

    def set_balance(self, amount: int) -> None:
        prev = self.data.balance
        self._db.journal.append(_revert_balance(self.address, prev), self.address)
        self.data.balance = amount

    def touch(self) -> None:
        self._db.journal.append(_revert_touch(self.address), self.address)
        if self.address == RIPEMD_ADDR:
            # journal.go touchChange: the ripemd account stays in the dirty
            # set even when its touch is reverted (the 2016 consensus quirk);
            # an extra dirty count makes the revert's decrement a no-op
            self._db.journal.dirties[self.address] = (
                self._db.journal.dirties.get(self.address, 0) + 1
            )

    # ----------------------------------------------------------- multicoin

    def balance_multicoin(self, coin_id: bytes) -> int:
        return int.from_bytes(self.get_state(normalize_coin_id(coin_id)), "big")

    def set_balance_multicoin(self, coin_id: bytes, amount: int) -> None:
        self.enable_multicoin()
        self.set_state(
            normalize_coin_id(coin_id), amount.to_bytes(32, "big")
        )

    def add_balance_multicoin(self, coin_id: bytes, amount: int) -> None:
        if amount == 0:
            if self.empty:
                self.touch()
            return
        self.set_balance_multicoin(
            coin_id, self.balance_multicoin(coin_id) + amount
        )

    def sub_balance_multicoin(self, coin_id: bytes, amount: int) -> None:
        if amount == 0:
            return
        self.set_balance_multicoin(
            coin_id, self.balance_multicoin(coin_id) - amount
        )

    def enable_multicoin(self) -> None:
        if self.data.is_multi_coin:
            return
        self._db.journal.append(_revert_multicoin(self.address), self.address)
        self.data.is_multi_coin = True

    # ----------------------------------------------------------- nonce/code

    def set_nonce(self, nonce: int) -> None:
        prev = self.data.nonce
        self._db.journal.append(_revert_nonce(self.address, prev), self.address)
        self.data.nonce = nonce

    def get_code(self) -> bytes:
        if self.code is not None:
            return self.code
        if self.data.code_hash == EMPTY_CODE_HASH:
            self.code = b""
            return b""
        code = self._db.db.contract_code(self.addr_hash, self.data.code_hash)
        if code is None:
            raise KeyError(f"missing code {self.data.code_hash.hex()}")
        self.code = code
        return code

    def set_code(self, code_hash: bytes, code: bytes) -> None:
        prev_hash, prev_code = self.data.code_hash, self.get_code()
        self._db.journal.append(
            _revert_code(self.address, prev_hash, prev_code), self.address
        )
        self.code = code
        self.data.code_hash = code_hash
        self.dirty_code = True

    def copy(self, db) -> "StateObject":
        o = StateObject.__new__(StateObject)
        o._db = db
        o.address = self.address
        o.addr_hash = self.addr_hash
        o.data = self.data.copy()
        o.origin = self.origin.copy() if self.origin else None
        o.code = self.code
        o.dirty_code = self.dirty_code
        o.suicided = self.suicided
        o.deleted = self.deleted
        o.origin_storage = dict(self.origin_storage)
        o.pending_storage = dict(self.pending_storage)
        o.snap_flush = dict(self.snap_flush)
        o.dirty_storage = dict(self.dirty_storage)
        o._trie = self._trie.copy() if self._trie is not None else None
        return o


# journal revert closures ----------------------------------------------------

def _revert_storage(addr, key, prev):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.dirty_storage[key] = prev
    return rev


def _revert_balance(addr, prev):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.data.balance = prev
    return rev


def _revert_nonce(addr, prev):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.data.nonce = prev
    return rev


def _revert_code(addr, prev_hash, prev_code):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.code = prev_code
            obj.data.code_hash = prev_hash
            obj.dirty_code = False
    return rev


def _revert_multicoin(addr):
    def rev(db):
        obj = db._objects.get(addr)
        if obj is not None:
            obj.data.is_multi_coin = False
    return rev


def _revert_touch(addr):
    def rev(db):
        pass
    return rev
