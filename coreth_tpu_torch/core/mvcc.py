"""MVCC substrate of optimistic parallel execution; counterpart of
coreth_tpu/core/mvcc.py.

The multi-version write table, block-parent snapshot reader and
`VersionedStateView` (the StateDB lookalike a speculative tx incarnation
executes against) live here, split out of `parallel_exec` so the shard
workers can import them WITHOUT the parent's metrics singletons
(`parallel_exec` wires scheduler counters/timers at module scope; a worker
carrying that import would count into a registry nobody reads). This
module must stay free of module-scope imports of `coreth_tpu_torch.metrics`
and `coreth_tpu_torch.core.blockchain`, and of torch: a worker never
touches the device.

Semantics notes (Block-STM read resolution, journal mirroring, write-set
construction) are documented on the classes; the scheduler that drives
them is in `parallel_exec`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..native import keccak256
from ..state.access_list import AccessList
from ..state.account import EMPTY_CODE_HASH, normalize_coin_id, normalize_state_key
from ..state.state_object import RIPEMD_ADDR, ZERO32

# read-version sentinel for "resolved from the block-parent snapshot"
BASE = ("base",)
_MISS = object()


class _CoinbaseRead(Exception):
    """A tx read the fee recipient, whose balance exists only as deferred
    per-tx deltas during parallel execution — the block must run serially."""


# --------------------------------------------------------------------------
# multi-version write table


class _VersionedTable:
    """Block-STM's MVMemory: per-location maps of tx-index → (incarnation,
    value). Account resets/deletions publish *barriers* that shadow all
    lower-indexed storage writes (a recreated account starts with empty
    storage). All mutable fields are guarded by self.lock.
    """

    def __init__(self):
        self.lock = threading.Lock()
        # addr -> {tx_index -> (incarnation, account_tuple_or_None)}
        self.accounts: Dict[bytes, Dict[int, tuple]] = {}
        # (addr, normalized_key) -> {tx_index -> (incarnation, value)}
        self.slots: Dict[Tuple[bytes, bytes], Dict[int, tuple]] = {}
        # addr -> {tx_index -> incarnation}: storage reset points
        self.barriers: Dict[bytes, Dict[int, int]] = {}
        # tx_index -> (addr list, slot-key list, barrier-addr list) for
        # unpublish-on-reexec
        self.published: Dict[int, tuple] = {}
        self.latest_inc: Dict[int, int] = {}

    def read_account(self, i: int, addr: bytes):
        """Highest write below tx i; (_MISS, BASE) when only the parent
        snapshot can answer."""
        with self.lock:
            ent = self.accounts.get(addr)
            if ent:
                best = -1
                for j in ent:
                    if best < j < i:
                        best = j
                if best >= 0:
                    inc, val = ent[best]
                    return val, ("a", best, inc)
            return _MISS, BASE

    def read_slot(self, i: int, addr: bytes, key: bytes):
        """Storage resolution: the highest write below i wins unless an
        account reset (barrier) sits strictly above it — then the slot is
        zero as of that reset. A tx that resets AND writes a slot holds
        both at the same index; the write wins (jw == jb)."""
        with self.lock:
            jw = -1
            went = self.slots.get((addr, key))
            if went:
                for j in went:
                    if jw < j < i:
                        jw = j
            jb = -1
            bent = self.barriers.get(addr)
            if bent:
                for j in bent:
                    if jb < j < i:
                        jb = j
            if jb > jw:
                return ZERO32, ("b", jb, bent[jb])
            if jw >= 0:
                inc, val = went[jw]
                return val, ("s", jw, inc)
            return _MISS, BASE

    def publish(self, i: int, inc: int, ws) -> None:
        """Replace tx i's table entries with incarnation inc's write-set
        (None write-set = a failed incarnation: just clear)."""
        with self.lock:
            if inc < self.latest_inc.get(i, -1):
                return  # a stale incarnation finished after its abort
            self.latest_inc[i] = inc
            old = self.published.pop(i, None)
            if old is not None:
                for addr in old[0]:
                    d = self.accounts.get(addr)
                    if d:
                        d.pop(i, None)
                for sk in old[1]:
                    d = self.slots.get(sk)
                    if d:
                        d.pop(i, None)
                for addr in old[2]:
                    d = self.barriers.get(addr)
                    if d:
                        d.pop(i, None)
            if ws is None:
                return
            for addr, val in ws.accounts.items():
                self.accounts.setdefault(addr, {})[i] = (inc, val)
            for sk, v in ws.storage.items():
                self.slots.setdefault(sk, {})[i] = (inc, v)
            for addr in ws.barriers:
                self.barriers.setdefault(addr, {})[i] = inc
            self.published[i] = (
                list(ws.accounts), list(ws.storage), list(ws.barriers),
            )

    def validate(self, i: int, reads: Dict[tuple, tuple]) -> bool:
        """Re-resolve every recorded read version; equal incarnation tags
        imply equal values, so version comparison suffices (Block-STM §4)."""
        with self.lock:
            for loc, ver in reads.items():
                if loc[0] == "a":
                    addr = loc[1]
                    cur = BASE
                    ent = self.accounts.get(addr)
                    if ent:
                        best = -1
                        for j in ent:
                            if best < j < i:
                                best = j
                        if best >= 0:
                            cur = ("a", best, ent[best][0])
                else:
                    addr, key = loc[1], loc[2]
                    jw = -1
                    went = self.slots.get((addr, key))
                    if went:
                        for j in went:
                            if jw < j < i:
                                jw = j
                    jb = -1
                    bent = self.barriers.get(addr)
                    if bent:
                        for j in bent:
                            if jb < j < i:
                                jb = j
                    if jb > jw:
                        cur = ("b", jb, bent[jb])
                    elif jw >= 0:
                        cur = ("s", jw, went[jw][0])
                    else:
                        cur = BASE
                if cur != ver:
                    return False
        return True


# --------------------------------------------------------------------------
# block-parent snapshot reader


class _BaseReader:
    """Serialised, memoised reads of the block-parent StateDB. The StateDB
    and its StateObject caches are not thread-safe, so every base read
    funnels through self.lock; cached values are immutable tuples/bytes so
    they are then safe to hand to any worker."""

    def __init__(self, statedb):
        self.lock = threading.Lock()
        self.sdb = statedb
        self.accounts: Dict[bytes, Optional[tuple]] = {}
        self.slots: Dict[Tuple[bytes, bytes], bytes] = {}
        self.codes: Dict[bytes, bytes] = {}

    @property
    def batch_keccak(self):
        """The parent StateDB's device seam (StateDB.batch_keccak)."""
        return self.sdb.batch_keccak

    def account(self, addr: bytes) -> Optional[tuple]:
        """(nonce, balance, code_hash, is_multi_coin) or None (absent)."""
        with self.lock:
            if addr in self.accounts:
                return self.accounts[addr]
            obj = self.sdb._get_state_object(addr)
            val = None
            if obj is not None:
                d = obj.data
                val = (d.nonce, d.balance, d.code_hash, d.is_multi_coin)
            self.accounts[addr] = val
            return val

    def slot(self, addr: bytes, key: bytes) -> bytes:
        sk = (addr, key)
        with self.lock:
            v = self.slots.get(sk)
            if v is not None:
                return v
            obj = self.sdb._get_state_object(addr)
            v = obj.get_state(key) if obj is not None else ZERO32
            self.slots[sk] = v
            return v

    def code(self, addr: bytes) -> bytes:
        with self.lock:
            c = self.codes.get(addr)
            if c is None:
                obj = self.sdb._get_state_object(addr)
                c = obj.get_code() if obj is not None else b""
                self.codes[addr] = c
            return c


# --------------------------------------------------------------------------
# per-tx materialised account + write-set


class _VAccount:
    __slots__ = (
        "exists", "nonce", "balance", "code_hash", "code", "code_dirty",
        "is_multi_coin", "suicided", "fresh", "storage",
    )

    def __init__(self):
        self.exists = False
        self.nonce = 0
        self.balance = 0
        self.code_hash = EMPTY_CODE_HASH
        self.code: Optional[bytes] = b""
        self.code_dirty = False
        self.is_multi_coin = False
        self.suicided = False
        # fresh = (re)created by THIS tx: storage starts empty, so slot
        # reads stop resolving to lower txs / base, and the publish adds a
        # barrier
        self.fresh = False
        self.storage: Dict[bytes, bytes] = {}


class _WriteSet:
    __slots__ = ("accounts", "storage", "barriers", "logs", "preimages", "fee")

    def __init__(self, accounts, storage, barriers, logs, preimages, fee):
        self.accounts = accounts  # addr -> account tuple | None (deleted)
        self.storage = storage    # (addr, key) -> value
        self.barriers = barriers  # [addr]
        self.logs = logs          # [Log] in emit order
        self.preimages = preimages
        self.fee = fee            # coinbase delta (commutative)


class _RecordingGasPool:
    """StateTransition's gas pool ops are block-serial state; record them
    and replay against the real pool in tx-index order before the fold."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: List[Tuple[str, int]] = []

    def sub_gas(self, amount: int) -> None:
        self.ops.append(("sub", amount))

    def add_gas(self, amount: int) -> None:
        self.ops.append(("add", amount))


# --------------------------------------------------------------------------
# the versioned state view


class VersionedStateView:
    """StateDB lookalike for one tx incarnation (single-threaded; the only
    shared structures it touches — the versioned table and the base reader
    — carry their own locks).

    Mirrors the serial StateDB/StateObject/Journal semantics exactly:
    every account op first materialises a local `_VAccount` copy (and
    records the read that produced it), every mutation pushes an undo
    closure plus a journal-dirties increment, and `build_write_set`
    reproduces `finalise(delete_empty=True)`'s dirties walk — including
    the RIPEMD touch quirk and empty-account deletion.
    """

    def __init__(self, table: _VersionedTable, base: _BaseReader,
                 tx_index: int, coinbase: bytes):
        self.table = table
        self.base = base
        self.tx_index = tx_index
        self.coinbase = coinbase
        # loc -> version; loc is ("a", addr) or ("s", addr, key)
        self.reads: Dict[tuple, tuple] = {}
        self._accounts: Dict[bytes, _VAccount] = {}
        self._slot_cache: Dict[Tuple[bytes, bytes], bytes] = {}
        self._undo: List[tuple] = []  # (closure_or_None, dirtied_addr_or_None)
        self._dirties: Dict[bytes, int] = {}
        self._logs: List = []
        self._preimages: Dict[bytes, bytes] = {}
        self.refund = 0
        self._fee = 0
        self.transient: Dict[Tuple[bytes, bytes], bytes] = {}
        self.access_list = AccessList()
        self.this_tx_hash = b"\x00" * 32

    @property
    def batch_keccak(self):
        """The device seam of the state under the view (StateDB.
        batch_keccak through the base reader), None where the base has
        none: a shard worker's base never touches the device."""
        return getattr(self.base, "batch_keccak", None)

    # ------------------------------------------------------ journal mirror

    def _journal(self, undo, addr: Optional[bytes] = None) -> None:
        self._undo.append((undo, addr))
        if addr is not None:
            self._dirties[addr] = self._dirties.get(addr, 0) + 1

    def snapshot(self) -> int:
        return len(self._undo)

    def revert_to_snapshot(self, mark: int) -> None:
        for idx in range(len(self._undo) - 1, mark - 1, -1):
            undo, addr = self._undo[idx]
            if undo is not None:
                undo()
            if addr is not None:
                n = self._dirties[addr] - 1
                if n == 0:
                    del self._dirties[addr]
                else:
                    self._dirties[addr] = n
        del self._undo[mark:]

    # -------------------------------------------------------- resolution

    def _resolve(self, addr: bytes) -> _VAccount:
        acc = self._accounts.get(addr)
        if acc is not None:
            return acc
        if addr == self.coinbase:
            raise _CoinbaseRead(addr.hex())
        acc = _VAccount()
        val, ver = self.table.read_account(self.tx_index, addr)
        if val is _MISS:
            val = self.base.account(addr)
            if val is not None:
                acc.exists = True
                acc.nonce, acc.balance, acc.code_hash, acc.is_multi_coin = val
                acc.code = None  # lazily via base
        elif val is not None:
            acc.exists = True
            (acc.nonce, acc.balance, acc.code_hash, code, _code_dirty,
             acc.is_multi_coin, _fresh) = val
            # the lower tx's fresh/code_dirty flags describe ITS actions,
            # not this tx's; only the data carries over
            acc.code = code
        self.reads[("a", addr)] = ver
        self._accounts[addr] = acc
        return acc

    def _load_committed_slot(self, addr: bytes, key: bytes) -> bytes:
        """Pre-tx slot value (serial get_committed_state below the dirty
        map): versioned table → block-parent snapshot; read recorded."""
        sk = (addr, key)
        v = self._slot_cache.get(sk)
        if v is not None:
            return v
        v, ver = self.table.read_slot(self.tx_index, addr, key)
        if v is _MISS:
            v = self.base.slot(addr, key)
        self.reads[("s", addr, key)] = ver
        self._slot_cache[sk] = v
        return v

    # ----------------------------------------------------------- reads

    def exist(self, addr: bytes) -> bool:
        return self._resolve(addr).exists

    @staticmethod
    def _is_empty(acc: _VAccount) -> bool:
        return (acc.nonce == 0 and acc.balance == 0
                and acc.code_hash == EMPTY_CODE_HASH
                and not acc.is_multi_coin)

    def empty(self, addr: bytes) -> bool:
        acc = self._resolve(addr)
        return (not acc.exists) or self._is_empty(acc)

    def get_balance(self, addr: bytes) -> int:
        acc = self._resolve(addr)
        return acc.balance if acc.exists else 0

    def get_nonce(self, addr: bytes) -> int:
        acc = self._resolve(addr)
        return acc.nonce if acc.exists else 0

    def get_code_hash(self, addr: bytes) -> bytes:
        acc = self._resolve(addr)
        return acc.code_hash if acc.exists else b"\x00" * 32

    def get_code(self, addr: bytes) -> bytes:
        acc = self._resolve(addr)
        if not acc.exists:
            return b""
        if acc.code is None:
            # code bytes are content-addressed by code_hash: any lower tx
            # that changed the hash also published the bytes, so a None
            # here always means "unchanged from base"
            acc.code = (b"" if acc.code_hash == EMPTY_CODE_HASH
                        else self.base.code(addr))
        return acc.code

    def get_code_size(self, addr: bytes) -> int:
        return len(self.get_code(addr))

    def has_suicided(self, addr: bytes) -> bool:
        acc = self._resolve(addr)
        return acc.suicided if acc.exists else False

    def get_state(self, addr: bytes, key: bytes) -> bytes:
        return self._get_state_norm(addr, normalize_state_key(key))

    def _get_state_norm(self, addr: bytes, key: bytes) -> bytes:
        acc = self._resolve(addr)
        v = acc.storage.get(key)
        if v is not None:
            return v
        if not acc.exists or acc.fresh:
            return ZERO32
        return self._load_committed_slot(addr, key)

    def get_committed_state(self, addr: bytes, key: bytes) -> bytes:
        key = normalize_state_key(key)
        acc = self._resolve(addr)
        if not acc.exists or acc.fresh:
            return ZERO32
        return self._load_committed_slot(addr, key)

    def get_balance_multicoin(self, addr: bytes, coin_id: bytes) -> int:
        acc = self._resolve(addr)
        if not acc.exists:
            return 0
        return int.from_bytes(
            self._get_state_norm(addr, normalize_coin_id(coin_id)), "big"
        )

    # ----------------------------------------------------------- writes

    def _get_or_new(self, addr: bytes) -> _VAccount:
        acc = self._resolve(addr)
        if not acc.exists:
            self._reset_account(acc, addr, carry_balance=False)
        return acc

    def _reset_account(self, acc: _VAccount, addr: bytes,
                       carry_balance: bool) -> None:
        """Serial _create_object: a brand-new object replaces (or creates)
        the entry; the undo restores the prior image wholesale."""
        prior = (acc.exists, acc.nonce, acc.balance, acc.code_hash, acc.code,
                 acc.code_dirty, acc.is_multi_coin, acc.suicided, acc.fresh,
                 acc.storage)

        def undo(acc=acc, prior=prior):
            (acc.exists, acc.nonce, acc.balance, acc.code_hash, acc.code,
             acc.code_dirty, acc.is_multi_coin, acc.suicided,
             acc.fresh) = prior[:9]
            acc.storage = prior[9]

        self._journal(undo, addr)
        bal = acc.balance if (acc.exists and carry_balance) else 0
        acc.exists = True
        acc.nonce = 0
        acc.code_hash = EMPTY_CODE_HASH
        acc.code = b""
        acc.code_dirty = False
        acc.is_multi_coin = False
        acc.suicided = False
        acc.fresh = True
        acc.storage = {}
        acc.balance = 0
        if bal:
            # create_account carries the balance via set_balance on the new
            # object (its own journal entry, like the serial path)
            self._set_balance(acc, addr, bal)

    def create_account(self, addr: bytes) -> None:
        acc = self._resolve(addr)
        self._reset_account(acc, addr, carry_balance=True)

    def _set_balance(self, acc: _VAccount, addr: bytes, value: int) -> None:
        prev = acc.balance

        def undo(acc=acc, prev=prev):
            acc.balance = prev

        self._journal(undo, addr)
        acc.balance = value

    def _touch(self, acc: _VAccount, addr: bytes) -> None:
        self._journal(None, addr)
        if addr == RIPEMD_ADDR:
            # journal.go touchChange: ripemd stays dirty through reverts
            self._dirties[addr] = self._dirties.get(addr, 0) + 1

    def add_balance(self, addr: bytes, amount: int) -> None:
        if addr == self.coinbase and amount != 0:
            prev = self._fee

            def undo(prev=prev):
                self._fee = prev

            self._journal(undo)
            self._fee += amount
            return
        # amount == 0 on the coinbase needs the empty check → a real read
        # → _CoinbaseRead via _resolve, which is exactly the fallback we
        # want (the serial path would touch, possibly deleting it)
        acc = self._get_or_new(addr)
        if amount == 0:
            if self._is_empty(acc):
                self._touch(acc, addr)
            return
        self._set_balance(acc, addr, acc.balance + amount)

    def sub_balance(self, addr: bytes, amount: int) -> None:
        acc = self._get_or_new(addr)
        if amount == 0:
            return
        self._set_balance(acc, addr, acc.balance - amount)

    def set_balance(self, addr: bytes, amount: int) -> None:
        acc = self._get_or_new(addr)
        self._set_balance(acc, addr, amount)

    def set_nonce(self, addr: bytes, nonce: int) -> None:
        acc = self._get_or_new(addr)
        prev = acc.nonce

        def undo(acc=acc, prev=prev):
            acc.nonce = prev

        self._journal(undo, addr)
        acc.nonce = nonce

    def set_code(self, addr: bytes, code: bytes) -> None:
        acc = self._get_or_new(addr)
        prev_hash, prev_code = acc.code_hash, self.get_code(addr)

        def undo(acc=acc, prev_hash=prev_hash, prev_code=prev_code):
            acc.code_hash = prev_hash
            acc.code = prev_code
            acc.code_dirty = False  # serial _revert_code does the same

        self._journal(undo, addr)
        acc.code = code
        acc.code_hash = keccak256(code)
        acc.code_dirty = True

    def set_state(self, addr: bytes, key: bytes, value: bytes) -> None:
        self._set_state_norm(addr, normalize_state_key(key), value)

    def _set_state_norm(self, addr: bytes, key: bytes, value: bytes) -> None:
        acc = self._get_or_new(addr)
        prev = self._get_state_norm(addr, key)
        if prev == value:
            return
        had = key in acc.storage

        def undo(acc=acc, key=key, had=had, prev=prev):
            if had:
                acc.storage[key] = prev
            else:
                acc.storage.pop(key, None)

        self._journal(undo, addr)
        acc.storage[key] = value

    def suicide(self, addr: bytes) -> bool:
        acc = self._resolve(addr)
        if not acc.exists:
            return False
        prev = (acc.suicided, acc.balance)

        def undo(acc=acc, prev=prev):
            acc.suicided, acc.balance = prev

        self._journal(undo, addr)
        acc.suicided = True
        acc.balance = 0
        return True

    def _enable_multicoin(self, acc: _VAccount, addr: bytes) -> None:
        if acc.is_multi_coin:
            return

        def undo(acc=acc):
            acc.is_multi_coin = False

        self._journal(undo, addr)
        acc.is_multi_coin = True

    def add_balance_multicoin(self, addr: bytes, coin_id: bytes,
                              amount: int) -> None:
        acc = self._get_or_new(addr)
        if amount == 0:
            if self._is_empty(acc):
                self._touch(acc, addr)
            return
        cur = int.from_bytes(
            self._get_state_norm(addr, normalize_coin_id(coin_id)), "big"
        )
        self._enable_multicoin(acc, addr)
        self._set_state_norm(
            addr, normalize_coin_id(coin_id), (cur + amount).to_bytes(32, "big")
        )

    def sub_balance_multicoin(self, addr: bytes, coin_id: bytes,
                              amount: int) -> None:
        acc = self._get_or_new(addr)
        if amount == 0:
            return
        cur = int.from_bytes(
            self._get_state_norm(addr, normalize_coin_id(coin_id)), "big"
        )
        self._enable_multicoin(acc, addr)
        self._set_state_norm(
            addr, normalize_coin_id(coin_id), (cur - amount).to_bytes(32, "big")
        )

    # ------------------------------------------------- tx-scoped side state

    def get_transient_state(self, addr: bytes, key: bytes) -> bytes:
        return self.transient.get((addr, key), ZERO32)

    def set_transient_state(self, addr: bytes, key: bytes, value: bytes) -> None:
        prev = self.get_transient_state(addr, key)
        if prev == value:
            return

        def undo(addr=addr, key=key, prev=prev):
            self.transient[(addr, key)] = prev

        self._journal(undo)
        self.transient[(addr, key)] = value

    def get_refund(self) -> int:
        return self.refund

    def add_refund(self, gas: int) -> None:
        prev = self.refund

        def undo(prev=prev):
            self.refund = prev

        self._journal(undo)
        self.refund += gas

    def sub_refund(self, gas: int) -> None:
        prev = self.refund
        if gas > self.refund:
            raise ValueError(f"refund counter below zero ({self.refund} < {gas})")

        def undo(prev=prev):
            self.refund = prev

        self._journal(undo)
        self.refund -= gas

    def add_log(self, log) -> None:
        def undo():
            self._logs.pop()

        self._journal(undo)
        self._logs.append(log)

    def add_preimage(self, hash_: bytes, preimage: bytes) -> None:
        if hash_ not in self._preimages:
            def undo(hash_=hash_):
                self._preimages.pop(hash_, None)

            self._journal(undo)
            self._preimages[hash_] = preimage

    def set_tx_context(self, tx_hash: bytes, tx_index: int) -> None:
        self.this_tx_hash = tx_hash

    # ------------------------------------------------- access list / prepare

    def prepare(self, rules, sender, coinbase, dst, precompiles,
                tx_access_list) -> None:
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
            def undo(addr=addr):
                self.access_list.delete_address(addr)

            self._journal(undo)

    def add_slot_to_access_list(self, addr: bytes, slot: bytes) -> None:
        addr_added, slot_added = self.access_list.add_slot(addr, slot)
        if addr_added:
            def undo_a(addr=addr):
                self.access_list.delete_address(addr)

            self._journal(undo_a)
        if slot_added:
            def undo_s(addr=addr, slot=slot):
                self.access_list.delete_slot(addr, slot)

            self._journal(undo_s)

    # ------------------------------------------------------------ write-set

    def build_write_set(self) -> _WriteSet:
        """finalise(delete_empty=True) over the journal dirties, expressed
        as a publishable write-set instead of StateObject mutation."""
        accounts: Dict[bytes, Optional[tuple]] = {}
        storage: Dict[Tuple[bytes, bytes], bytes] = {}
        barriers: List[bytes] = []
        for addr in self._dirties:  # insertion-ordered, like journal.dirties
            acc = self._accounts.get(addr)
            if acc is None or not acc.exists:
                continue
            if acc.suicided or self._is_empty(acc):
                accounts[addr] = None
                barriers.append(addr)
            else:
                accounts[addr] = (
                    acc.nonce, acc.balance, acc.code_hash, acc.code,
                    acc.code_dirty, acc.is_multi_coin, acc.fresh,
                )
                if acc.fresh:
                    barriers.append(addr)
                for k, v in acc.storage.items():
                    storage[(addr, k)] = v
        return _WriteSet(accounts, storage, barriers, list(self._logs),
                         dict(self._preimages), self._fee)
