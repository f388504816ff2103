"""Canonical chain types (semantics of coreth core/types/); counterpart of
coreth_tpu/core/types.py.

Header/Block/Body RLP mirror coreth's extblock layout (core/types/block.go:
73-110,177-183): the header carries Avalanche extras (ExtDataHash + optional
BaseFee/ExtDataGasUsed/BlockGasCost), the block body carries [header, txs,
uncles, version, extdata]. Transactions: legacy, EIP-2930 access-list, and
EIP-1559 dynamic-fee (core/types/transaction.go). Receipts + 2048-bit log
bloom; DeriveSha over a StackTrie (core/types/hashing.go).

Sender recovery runs on the native secp256k1 (native/secp.py), whose
failed build raises; the reference drifts to pure Python when its build
fails. The pure-Python `crypto.secp256k1.recover_address` stays the
oracle, reached only by an explicit call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .. import rlp
from ..crypto import secp256k1
from ..native import keccak256
from ..trie.node import EMPTY_ROOT
from ..trie.stacktrie import StackTrie

HASH_LEN = 32
ADDR_LEN = 20
ZERO_HASH = b"\x00" * 32
ZERO_ADDR = b"\x00" * 20

EMPTY_TXS_HASH = EMPTY_ROOT
EMPTY_RECEIPTS_HASH = EMPTY_ROOT
# keccak256(rlp([])) (held as a constant so importing builds nothing)
EMPTY_UNCLE_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347")

LEGACY_TX_TYPE = 0
ACCESS_LIST_TX_TYPE = 1
DYNAMIC_FEE_TX_TYPE = 2

RECEIPT_STATUS_FAILED = 0
RECEIPT_STATUS_SUCCESSFUL = 1


def _u(b: bytes) -> int:
    return int.from_bytes(b, "big")


# ---------------------------------------------------------------------------
# Access list
# ---------------------------------------------------------------------------

AccessTuple = Tuple[bytes, List[bytes]]  # (address, [storage keys])


def _access_list_rlp(al: Sequence[AccessTuple]):
    return [[addr, list(keys)] for addr, keys in al]


def _access_list_from_rlp(items) -> List[AccessTuple]:
    return [(entry[0], list(entry[1])) for entry in items]


# ---------------------------------------------------------------------------
# Transactions
# ---------------------------------------------------------------------------

@dataclass
class Transaction:
    """One object for all three tx envelopes; `type` picks the codec."""

    type: int = LEGACY_TX_TYPE
    chain_id: Optional[int] = None  # None for unprotected legacy
    nonce: int = 0
    gas_price: int = 0          # legacy/2930; == max_fee for 1559 accessors
    max_priority_fee: int = 0   # 1559 (GasTipCap)
    max_fee: int = 0            # 1559 (GasFeeCap)
    gas: int = 0
    to: Optional[bytes] = None  # None = contract creation
    value: int = 0
    data: bytes = b""
    access_list: List[AccessTuple] = field(default_factory=list)
    v: int = 0
    r: int = 0
    s: int = 0

    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)
    _sender: Optional[bytes] = field(default=None, repr=False, compare=False)

    # fee accessors (transaction.go GasTipCap/GasFeeCap semantics)
    @property
    def gas_tip_cap(self) -> int:
        return self.max_priority_fee if self.type == DYNAMIC_FEE_TX_TYPE else self.gas_price

    @property
    def gas_fee_cap(self) -> int:
        return self.max_fee if self.type == DYNAMIC_FEE_TX_TYPE else self.gas_price

    def effective_gas_tip(self, base_fee: Optional[int]) -> int:
        if base_fee is None:
            return self.gas_tip_cap
        return min(self.gas_tip_cap, self.gas_fee_cap - base_fee)

    def effective_gas_price(self, base_fee: Optional[int]) -> int:
        if base_fee is None or self.type != DYNAMIC_FEE_TX_TYPE:
            return self.gas_price
        return min(self.max_fee, self.max_priority_fee + base_fee)

    def cost(self) -> int:
        return self.gas * self.gas_fee_cap + self.value

    # ------------------------------------------------------------- encoding

    def _to_field(self):
        return self.to if self.to is not None else b""

    def payload_items(self, for_signing: bool, chain_id: Optional[int] = None):
        cid = chain_id if chain_id is not None else (self.chain_id or 0)
        if self.type == LEGACY_TX_TYPE:
            items = [
                self.nonce, self.gas_price, self.gas, self._to_field(),
                self.value, self.data,
            ]
            if for_signing:
                if cid:
                    items += [cid, 0, 0]  # EIP-155
            else:
                items += [self.v, self.r, self.s]
            return items
        if self.type == ACCESS_LIST_TX_TYPE:
            items = [
                cid, self.nonce, self.gas_price, self.gas, self._to_field(),
                self.value, self.data, _access_list_rlp(self.access_list),
            ]
        elif self.type == DYNAMIC_FEE_TX_TYPE:
            items = [
                cid, self.nonce, self.max_priority_fee, self.max_fee, self.gas,
                self._to_field(), self.value, self.data,
                _access_list_rlp(self.access_list),
            ]
        else:
            raise ValueError(f"unknown tx type {self.type}")
        if not for_signing:
            items += [self.v, self.r, self.s]
        return items

    def encode(self) -> bytes:
        """Canonical binary encoding (typed txs get their 1-byte prefix)."""
        payload = rlp.encode(self.payload_items(for_signing=False))
        if self.type == LEGACY_TX_TYPE:
            return payload
        return bytes([self.type]) + payload

    @classmethod
    def decode(cls, blob: bytes) -> "Transaction":
        if len(blob) > 0 and blob[0] <= 0x7F:  # typed envelope
            typ = blob[0]
            items = rlp.decode(blob[1:])
            if typ == ACCESS_LIST_TX_TYPE:
                return cls(
                    type=typ, chain_id=_u(items[0]), nonce=_u(items[1]),
                    gas_price=_u(items[2]), gas=_u(items[3]),
                    to=items[4] if items[4] else None, value=_u(items[5]),
                    data=items[6], access_list=_access_list_from_rlp(items[7]),
                    v=_u(items[8]), r=_u(items[9]), s=_u(items[10]),
                )
            if typ == DYNAMIC_FEE_TX_TYPE:
                return cls(
                    type=typ, chain_id=_u(items[0]), nonce=_u(items[1]),
                    max_priority_fee=_u(items[2]), max_fee=_u(items[3]),
                    gas_price=_u(items[3]), gas=_u(items[4]),
                    to=items[5] if items[5] else None, value=_u(items[6]),
                    data=items[7], access_list=_access_list_from_rlp(items[8]),
                    v=_u(items[9]), r=_u(items[10]), s=_u(items[11]),
                )
            raise rlp.DecodeError(f"unknown tx type {typ}")
        items = rlp.decode(blob)
        if not isinstance(items, list) or len(items) != 9:
            raise rlp.DecodeError("bad legacy tx")
        v = _u(items[6])
        chain_id = None
        if v >= 35:
            chain_id = (v - 35) // 2
        return cls(
            type=LEGACY_TX_TYPE, chain_id=chain_id, nonce=_u(items[0]),
            gas_price=_u(items[1]), gas=_u(items[2]),
            to=items[3] if items[3] else None, value=_u(items[4]),
            data=items[5], v=v, r=_u(items[7]), s=_u(items[8]),
        )

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = keccak256(self.encode())
        return self._hash

    @property
    def protected(self) -> bool:
        return self.type != LEGACY_TX_TYPE or self.v >= 35


# ---------------------------------------------------------------------------
# Signer (EIP-155 + typed txs; role of core/types/transaction_signing.go)
# ---------------------------------------------------------------------------

class Signer:
    def __init__(self, chain_id: int):
        self.chain_id = chain_id

    def sig_hash(self, tx: Transaction, protected: bool = True) -> bytes:
        # unprotected legacy txs (v=27/28) sign over the 6-item homestead
        # payload — chain_id=0 suppresses the EIP-155 suffix
        cid = self.chain_id if protected else 0
        items = tx.payload_items(for_signing=True, chain_id=cid)
        payload = rlp.encode(items)
        if tx.type == LEGACY_TX_TYPE:
            return keccak256(payload)
        return keccak256(bytes([tx.type]) + payload)

    def sign(self, tx: Transaction, priv: bytes) -> Transaction:
        if tx.type != LEGACY_TX_TYPE or self.chain_id:
            tx.chain_id = self.chain_id
        recid, r, s = secp256k1.sign(self.sig_hash(tx, protected=bool(self.chain_id)), priv)
        if tx.type == LEGACY_TX_TYPE:
            tx.v = recid + (35 + 2 * self.chain_id if self.chain_id else 27)
        else:
            tx.v = recid
        tx.r, tx.s = r, s
        tx._hash = None
        tx._sender = None
        return tx

    def sender(self, tx: Transaction) -> bytes:
        if tx._sender is not None:
            return tx._sender
        recid, protected = self._recid_of(tx)
        msg = self.sig_hash(tx, protected=protected)
        from ..native import secp

        addr = secp.recover_one(msg, recid, tx.r, tx.s)
        if addr is None:
            raise ValueError("invalid signature")
        tx._sender = addr
        return addr

    def _recid_of(self, tx: Transaction):
        """(recid, protected) per the sender() rules; raises on bad chain id."""
        if tx.type == LEGACY_TX_TYPE:
            if tx.v >= 35:
                if (tx.v - 35) // 2 != self.chain_id:
                    raise ValueError("invalid chain id for signer")
                return (tx.v - 35) % 2, True
            return tx.v - 27, False
        if (tx.chain_id or 0) != self.chain_id:
            raise ValueError("invalid chain id for signer")
        return tx.v, True

    def sender_batch(self, txs, native_threads: int = 0) -> None:
        """Batch-recover senders into each tx's cache — the sender-cacher
        drain (core/sender_cacher.go:88-115) on the native batched
        secp256k1; leaves invalid txs uncached so the per-tx sender()
        surfaces the precise error later.

        native_threads is forwarded to the native recover pool (0 = its
        hardware-concurrency default); sharded callers (the sender
        cacher) pass 1 so each shard owns one core and the Python-side
        item building (RLP + sig-hash keccak) of one shard overlaps the
        GIL-released native recovery of the others."""
        from ..native import secp

        todo = [tx for tx in txs if tx._sender is None]
        if not todo:
            return
        items = []
        ok_idx = []
        for i, tx in enumerate(todo):
            try:
                recid, protected = self._recid_of(tx)
            except Exception:
                from ..metrics import count_drop

                count_drop("core/sender_batch/recid_error")
                continue
            items.append((self.sig_hash(tx, protected=protected),
                          recid, tx.r, tx.s))
            ok_idx.append(i)
        addrs = secp.recover_batch(items, threads=native_threads)
        for i, addr in zip(ok_idx, addrs):
            if addr is not None:
                todo[i]._sender = addr


# ---------------------------------------------------------------------------
# Log / Receipt / Bloom
# ---------------------------------------------------------------------------

def bloom_bits(value: bytes) -> List[int]:
    h = keccak256(value)
    return [
        ((h[0] << 8 | h[1]) & 0x7FF),
        ((h[2] << 8 | h[3]) & 0x7FF),
        ((h[4] << 8 | h[5]) & 0x7FF),
    ]


def bloom_add(bloom: bytearray, value: bytes) -> None:
    for bit in bloom_bits(value):
        bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)


def bloom_lookup(bloom: bytes, value: bytes) -> bool:
    for bit in bloom_bits(value):
        if not bloom[256 - 1 - bit // 8] & (1 << (bit % 8)):
            return False
    return True


def logs_bloom(logs) -> bytes:
    b = bytearray(256)
    for log in logs:
        bloom_add(b, log.address)
        for t in log.topics:
            bloom_add(b, t)
    return bytes(b)


def create_bloom(receipts) -> bytes:
    b = bytearray(256)
    for rec in receipts:
        for log in rec.logs:
            bloom_add(b, log.address)
            for t in log.topics:
                bloom_add(b, t)
    return bytes(b)


@dataclass
class Receipt:
    type: int = LEGACY_TX_TYPE
    status: int = RECEIPT_STATUS_SUCCESSFUL
    cumulative_gas_used: int = 0
    bloom: bytes = b"\x00" * 256
    logs: list = field(default_factory=list)
    # derived fields (filled by DeriveFields)
    tx_hash: bytes = ZERO_HASH
    contract_address: Optional[bytes] = None
    gas_used: int = 0
    block_hash: bytes = ZERO_HASH
    block_number: int = 0
    transaction_index: int = 0
    effective_gas_price: int = 0

    def _log_items(self):
        return [[l.address, list(l.topics), l.data] for l in self.logs]

    def encode(self) -> bytes:
        payload = rlp.encode(
            [self.status, self.cumulative_gas_used, self.bloom, self._log_items()]
        )
        if self.type == LEGACY_TX_TYPE:
            return payload
        return bytes([self.type]) + payload

    @classmethod
    def decode(cls, blob: bytes) -> "Receipt":
        from ..state.log import Log

        typ = LEGACY_TX_TYPE
        if len(blob) > 0 and blob[0] <= 0x7F:
            typ = blob[0]
            blob = blob[1:]
        items = rlp.decode(blob)
        logs = []
        for li in items[3]:
            logs.append(Log(li[0], list(li[1]), li[2]))
        return cls(
            type=typ, status=_u(items[0]), cumulative_gas_used=_u(items[1]),
            bloom=items[2], logs=logs,
        )


def derive_receipt_fields(
    receipts: List[Receipt], txs: List[Transaction], block_hash: bytes,
    number: int, base_fee: Optional[int], signer: Signer,
) -> None:
    log_index = 0
    for i, (rec, tx) in enumerate(zip(receipts, txs)):
        rec.type = tx.type
        rec.tx_hash = tx.hash()
        rec.effective_gas_price = tx.effective_gas_price(base_fee)
        rec.block_hash = block_hash
        rec.block_number = number
        rec.transaction_index = i
        if tx.to is None:
            sender = signer.sender(tx)
            rec.contract_address = create_address(sender, tx.nonce)
        rec.gas_used = (
            rec.cumulative_gas_used
            - (receipts[i - 1].cumulative_gas_used if i > 0 else 0)
        )
        for l in rec.logs:
            l.block_number = number
            l.block_hash = block_hash
            l.tx_hash = rec.tx_hash
            l.tx_index = i
            l.index = log_index
            log_index += 1


def create_address(sender: bytes, nonce: int) -> bytes:
    return keccak256(rlp.encode([sender, nonce]))[12:]


def create_address2(sender: bytes, salt: bytes, code_hash: bytes) -> bytes:
    return keccak256(b"\xff" + sender + salt + code_hash)[12:]


# ---------------------------------------------------------------------------
# Header / Block
# ---------------------------------------------------------------------------

@dataclass
class Header:
    parent_hash: bytes = ZERO_HASH
    uncle_hash: bytes = EMPTY_UNCLE_HASH
    coinbase: bytes = ZERO_ADDR
    root: bytes = EMPTY_ROOT
    tx_hash: bytes = EMPTY_TXS_HASH
    receipt_hash: bytes = EMPTY_RECEIPTS_HASH
    bloom: bytes = b"\x00" * 256
    difficulty: int = 1
    number: int = 0
    gas_limit: int = 0
    gas_used: int = 0
    time: int = 0
    extra: bytes = b""
    mix_digest: bytes = ZERO_HASH
    nonce: bytes = b"\x00" * 8
    ext_data_hash: bytes = ZERO_HASH
    # optional trailing fields (rlp:"optional" in block.go:89-107)
    base_fee: Optional[int] = None
    ext_data_gas_used: Optional[int] = None
    block_gas_cost: Optional[int] = None
    excess_data_gas: Optional[int] = None

    def rlp_items(self):
        items = [
            self.parent_hash, self.uncle_hash, self.coinbase, self.root,
            self.tx_hash, self.receipt_hash, self.bloom, self.difficulty,
            self.number, self.gas_limit, self.gas_used, self.time,
            self.extra, self.mix_digest, self.nonce, self.ext_data_hash,
        ]
        # trailing optionals: a set field requires every earlier optional to
        # be set too (the reference's rlp:"optional" contract — fabricating a
        # zero would silently change the header hash)
        opts = [
            self.base_fee, self.ext_data_gas_used, self.block_gas_cost,
            self.excess_data_gas,
        ]
        last = -1
        for i, o in enumerate(opts):
            if o is not None:
                last = i
        for i in range(last + 1):
            if opts[i] is None:
                raise ValueError(
                    "non-contiguous optional header fields "
                    "(base_fee/ext_data_gas_used/block_gas_cost/excess_data_gas)"
                )
            items.append(opts[i])
        return items

    def encode(self) -> bytes:
        return rlp.encode(self.rlp_items())

    @classmethod
    def from_items(cls, items) -> "Header":
        h = cls(
            parent_hash=items[0], uncle_hash=items[1], coinbase=items[2],
            root=items[3], tx_hash=items[4], receipt_hash=items[5],
            bloom=items[6], difficulty=_u(items[7]), number=_u(items[8]),
            gas_limit=_u(items[9]), gas_used=_u(items[10]), time=_u(items[11]),
            extra=items[12], mix_digest=items[13], nonce=items[14],
            ext_data_hash=items[15],
        )
        opts = items[16:]
        if len(opts) > 0:
            h.base_fee = _u(opts[0])
        if len(opts) > 1:
            h.ext_data_gas_used = _u(opts[1])
        if len(opts) > 2:
            h.block_gas_cost = _u(opts[2])
        if len(opts) > 3:
            h.excess_data_gas = _u(opts[3])
        return h

    @classmethod
    def decode(cls, blob: bytes) -> "Header":
        return cls.from_items(rlp.decode(blob))

    def hash(self) -> bytes:
        return keccak256(self.encode())

    def copy(self) -> "Header":
        return Header(**{k: getattr(self, k) for k in self.__dataclass_fields__})


class Block:
    """extblock = [header, txs, uncles, version, extdata] (block.go:177)."""

    def __init__(
        self,
        header: Header,
        txs: Optional[List[Transaction]] = None,
        uncles: Optional[List[Header]] = None,
        version: int = 0,
        ext_data: Optional[bytes] = None,
    ):
        self.header = header
        self.transactions: List[Transaction] = txs or []
        self.uncles: List[Header] = uncles or []
        self.version = version
        self.ext_data = ext_data
        self._hash: Optional[bytes] = None

    @classmethod
    def assemble(
        cls, header: Header, txs, receipts, ext_data: Optional[bytes] = None,
        version: int = 0,
    ) -> "Block":
        """NewBlock semantics: derive tx/receipt/bloom/uncle roots."""
        h = header.copy()
        h.tx_hash = derive_sha(txs) if txs else EMPTY_TXS_HASH
        if receipts:
            h.receipt_hash = derive_sha(receipts)
            h.bloom = create_bloom(receipts)
        else:
            h.receipt_hash = EMPTY_RECEIPTS_HASH
        h.uncle_hash = EMPTY_UNCLE_HASH
        blk = cls(h, list(txs), [], version, ext_data)
        if ext_data is not None:
            blk.header.ext_data_hash = keccak256(ext_data)
        return blk

    @property
    def number(self) -> int:
        return self.header.number

    @property
    def root(self) -> bytes:
        return self.header.root

    @property
    def parent_hash(self) -> bytes:
        return self.header.parent_hash

    @property
    def gas_limit(self) -> int:
        return self.header.gas_limit

    @property
    def gas_used(self) -> int:
        return self.header.gas_used

    @property
    def time(self) -> int:
        return self.header.time

    @property
    def base_fee(self) -> Optional[int]:
        return self.header.base_fee

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = self.header.hash()
        return self._hash

    def encode(self) -> bytes:
        # ExtData is `*[]byte rlp:"nil"` in the reference (block.go:177):
        # nil encodes as the empty RLP string 0x80, so None and b"" are
        # indistinguishable on the wire and decode back to None
        ext = b"" if self.ext_data is None else self.ext_data
        return rlp.encode(
            [
                self.header.rlp_items(),
                [rlp.decode(t.encode()) if t.type == LEGACY_TX_TYPE else t.encode()
                 for t in self.transactions],
                [u.rlp_items() for u in self.uncles],
                self.version,
                ext,
            ]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "Block":
        items = rlp.decode(blob)
        header = Header.from_items(items[0])
        txs = []
        for ti in items[1]:
            if isinstance(ti, list):
                txs.append(Transaction.decode(rlp.encode(ti)))
            else:
                txs.append(Transaction.decode(ti))
        uncles = [Header.from_items(u) for u in items[2]]
        version = _u(items[3])
        ext = items[4] if items[4] != b"" else None
        return cls(header, txs, uncles, version, ext)


@dataclass
class Body:
    transactions: List[Transaction]
    uncles: List[Header]
    version: int = 0
    ext_data: Optional[bytes] = None


# ---------------------------------------------------------------------------
# DeriveSha (core/types/hashing.go over a StackTrie)
# ---------------------------------------------------------------------------

def derive_sha(items) -> bytes:
    """Root of the index->encoded-item trie, StackTrie-backed.

    Insertion order matches the reference (hashing.go:87-98): 1..127 first,
    then 0, then 128+, so the stack trie sees sorted-ish keys.
    """
    t = StackTrie()
    def enc(i):
        return items[i].encode()

    n = len(items)
    order = [i for i in range(1, min(n, 0x80))] + ([0] if n > 0 else []) + \
            [i for i in range(0x80, n)]
    for i in order:
        t.update(rlp.encode(i), enc(i))
    return t.hash()
