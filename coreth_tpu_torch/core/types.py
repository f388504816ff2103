"""Canonical chain types (semantics of coreth core/types/); counterpart of
coreth_tpu/core/types.py: the header, the block and its body, without
transactions.

Header/Block/Body RLP mirror coreth's extblock layout (core/types/block.go:
73-110,177-183): the header carries Avalanche extras (ExtDataHash +
optional BaseFee/ExtDataGasUsed/BlockGasCost), the block carries [header,
txs, uncles, version, extdata]. Transactions, signers, receipts, the log
bloom and DeriveSha over a StackTrie are not ported (ROADMAP "Still to
port", item 3b), so a block with transactions raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .. import rlp
from ..native import keccak256
from ..trie.node import EMPTY_ROOT

ZERO_HASH = b"\x00" * 32
ZERO_ADDR = b"\x00" * 20

EMPTY_TXS_HASH = EMPTY_ROOT
EMPTY_RECEIPTS_HASH = EMPTY_ROOT
# keccak256(rlp([])) (held as a constant so importing builds nothing)
EMPTY_UNCLE_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347")

_NO_TXS = ("transactions are not ported (ROADMAP 'Still to port', item 3b)")


def _u(b: bytes) -> int:
    return int.from_bytes(b, "big")


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
    """extblock = [header, txs, uncles, version, extdata] (block.go:177),
    with no transactions: a non-empty `txs` raises."""

    def __init__(
        self,
        header: Header,
        txs: Optional[list] = None,
        uncles: Optional[List[Header]] = None,
        version: int = 0,
        ext_data: Optional[bytes] = None,
    ):
        if txs:
            raise NotImplementedError(_NO_TXS)
        self.header = header
        self.transactions: list = []
        self.uncles: List[Header] = uncles or []
        self.version = version
        self.ext_data = ext_data
        self._hash: Optional[bytes] = None

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
                [],
                [u.rlp_items() for u in self.uncles],
                self.version,
                ext,
            ]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "Block":
        items = rlp.decode(blob)
        header = Header.from_items(items[0])
        if items[1]:
            raise NotImplementedError(_NO_TXS)
        uncles = [Header.from_items(u) for u in items[2]]
        version = _u(items[3])
        ext = items[4] if items[4] != b"" else None
        return cls(header, None, uncles, version, ext)


@dataclass
class Body:
    transactions: list
    uncles: List[Header]
    version: int = 0
    ext_data: Optional[bytes] = None
