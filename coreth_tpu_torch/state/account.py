"""Account model (semantics of coreth core/types/state_account.go);
counterpart of coreth_tpu/state/account.py.

Coreth's StateAccount is geth's plus an IsMultiCoin flag (state_account.go:
39-45): [nonce, balance, storage_root, code_hash, is_multi_coin], RLP in
that order. Multicoin balances themselves live in the storage trie under
bit-normalized keys (core/state/state_object.go:548-562).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import rlp
from ..trie.node import EMPTY_ROOT

# keccak256(b"") (held as a constant so importing builds nothing)
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@dataclass
class Account:
    nonce: int = 0
    balance: int = 0
    root: bytes = EMPTY_ROOT
    code_hash: bytes = EMPTY_CODE_HASH
    is_multi_coin: bool = False

    def encode(self) -> bytes:
        return rlp.encode(
            [
                self.nonce,
                self.balance,
                self.root,
                self.code_hash,
                1 if self.is_multi_coin else 0,
            ]
        )

    def encode_with_root_hole(self):
        """RLP with a zeroed storage-root slot + the slot's byte offset.

        The planned commit path (trie/planned.py) patches the storage
        trie's root digest into this hole on the device, so the account
        trie and every storage trie hash in one program."""
        enc = rlp.encode(
            [
                self.nonce,
                self.balance,
                b"\x00" * 32,
                self.code_hash,
                1 if self.is_multi_coin else 0,
            ]
        )
        # offset of the 32 root bytes: list header + nonce + balance + 0xa0
        payload = (
            len(rlp.encode(self.nonce)) + len(rlp.encode(self.balance))
            + 33 + len(rlp.encode(self.code_hash)) + 1
        )
        hdr = 1 if payload < 56 else 1 + (payload.bit_length() + 7) // 8
        off = (
            hdr + len(rlp.encode(self.nonce)) + len(rlp.encode(self.balance)) + 1
        )
        assert enc[off:off + 32] == b"\x00" * 32
        return enc, off

    @classmethod
    def decode(cls, blob: bytes) -> "Account":
        items = rlp.decode(blob)
        if not isinstance(items, list) or len(items) != 5:
            raise rlp.DecodeError("bad account RLP")
        return cls(
            nonce=rlp.decode_uint(items[0]),
            balance=rlp.decode_uint(items[1]),
            root=items[2],
            code_hash=items[3],
            is_multi_coin=rlp.decode_uint(items[4]) != 0,
        )

    def copy(self) -> "Account":
        return Account(
            self.nonce, self.balance, self.root, self.code_hash, self.is_multi_coin
        )

    @property
    def empty(self) -> bool:
        """Reference Empty() (core/state/state_object.go:102)."""
        return (
            self.nonce == 0
            and self.balance == 0
            and self.code_hash == EMPTY_CODE_HASH
            and not self.is_multi_coin
        )


def normalize_coin_id(coin_id: bytes) -> bytes:
    """OR bit 0 of byte 0 (state_object.go:552): multicoin storage keys."""
    return bytes([coin_id[0] | 0x01]) + coin_id[1:]


def normalize_state_key(key: bytes) -> bytes:
    """AND-out bit 0 of byte 0 (state_object.go:560): EVM storage keys."""
    return bytes([key[0] & 0xFE]) + key[1:]
