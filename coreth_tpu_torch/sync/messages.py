"""Typed sync wire messages (role of coreth plugin/evm/message/
{leafs_request,block_request,code_request,syncable,message}.go);
counterpart of coreth_tpu/sync/messages.py, byte-equal to it on every
message type.

RLP-framed with a one-byte type tag (the framework's linear codec).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .. import rlp
from ..native import keccak256

TYPE_LEAFS_REQUEST = 0
TYPE_LEAFS_RESPONSE = 1
TYPE_BLOCK_REQUEST = 2
TYPE_BLOCK_RESPONSE = 3
TYPE_CODE_REQUEST = 4
TYPE_CODE_RESPONSE = 5
TYPE_TX_GOSSIP = 6
TYPE_ATOMIC_TX_GOSSIP = 7
TYPE_ETH_CALL_REQUEST = 8
TYPE_ETH_CALL_RESPONSE = 9

MAX_LEAVES_LIMIT = 1024  # sync/handlers/leafs_request.go:34
MAX_CODE_HASHES_PER_REQUEST = 5




def _u(b) -> int:
    return int.from_bytes(b, "big") if isinstance(b, bytes) else b


@dataclass
class LeafsRequest:
    """message/leafs_request.go:43: a key range of one trie."""

    root: bytes
    account: bytes = b""      # storage trie owner (empty = account trie)
    start: bytes = b""
    end: bytes = b""
    limit: int = MAX_LEAVES_LIMIT

    def encode(self) -> bytes:
        return bytes([TYPE_LEAFS_REQUEST]) + rlp.encode(
            [self.root, self.account, self.start, self.end, self.limit]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "LeafsRequest":
        i = rlp.decode(blob)
        return cls(i[0], i[1], i[2], i[3], _u(i[4]))


@dataclass
class LeafsResponse:
    """message/leafs_request.go:81: leaves + range proof + more flag."""

    keys: List[bytes] = field(default_factory=list)
    vals: List[bytes] = field(default_factory=list)
    more: bool = False
    proof_vals: List[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        return bytes([TYPE_LEAFS_RESPONSE]) + rlp.encode(
            [list(self.keys), list(self.vals), 1 if self.more else 0,
             list(self.proof_vals)]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "LeafsResponse":
        i = rlp.decode(blob)
        return cls([bytes(k) for k in i[0]], [bytes(v) for v in i[1]],
                   _u(i[2]) != 0, [bytes(p) for p in i[3]])


@dataclass
class BlockRequest:
    """message/block_request.go: [parents] blocks ending at (hash, height)."""

    hash: bytes
    height: int
    parents: int

    def encode(self) -> bytes:
        return bytes([TYPE_BLOCK_REQUEST]) + rlp.encode(
            [self.hash, self.height, self.parents]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "BlockRequest":
        i = rlp.decode(blob)
        return cls(i[0], _u(i[1]), _u(i[2]))


@dataclass
class BlockResponse:
    blocks: List[bytes] = field(default_factory=list)  # RLP block bytes

    def encode(self) -> bytes:
        return bytes([TYPE_BLOCK_RESPONSE]) + rlp.encode([list(self.blocks)])

    @classmethod
    def decode(cls, blob: bytes) -> "BlockResponse":
        i = rlp.decode(blob)
        return cls([bytes(b) for b in i[0]])


@dataclass
class CodeRequest:
    hashes: List[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        return bytes([TYPE_CODE_REQUEST]) + rlp.encode([list(self.hashes)])

    @classmethod
    def decode(cls, blob: bytes) -> "CodeRequest":
        i = rlp.decode(blob)
        return cls([bytes(h) for h in i[0]])


@dataclass
class CodeResponse:
    data: List[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        return bytes([TYPE_CODE_RESPONSE]) + rlp.encode([list(self.data)])

    @classmethod
    def decode(cls, blob: bytes) -> "CodeResponse":
        i = rlp.decode(blob)
        return cls([bytes(d) for d in i[0]])


@dataclass
class SyncSummary:
    """message/syncable.go:21: a syncable state summary."""

    block_number: int
    block_hash: bytes
    block_root: bytes
    atomic_root: bytes = b"\x00" * 32

    def encode(self) -> bytes:
        return rlp.encode(
            [self.block_number, self.block_hash, self.block_root, self.atomic_root]
        )

    @classmethod
    def decode(cls, blob: bytes) -> "SyncSummary":
        i = rlp.decode(blob)
        return cls(_u(i[0]), i[1], i[2], i[3])

    def id(self) -> bytes:
        return keccak256(self.encode())


@dataclass
class EthCallRequest:
    """Cross-chain eth_call (message/eth_call_request.go + the typed
    cross-chain capability of peer/network.go:199-301): request_args is
    the UTF-8 JSON call object exactly as eth_call takes it."""

    request_args: bytes

    def encode(self) -> bytes:
        return bytes([TYPE_ETH_CALL_REQUEST]) + rlp.encode(
            [self.request_args])

    @classmethod
    def decode(cls, payload: bytes) -> "EthCallRequest":
        items = rlp.decode(payload)
        return cls(request_args=bytes(items[0]))


@dataclass
class EthCallResponse:
    """result: 0x-hex return data; error: empty when the call succeeded
    (reverts surface as error + the revert data in result)."""

    result: bytes
    error: bytes = b""

    def encode(self) -> bytes:
        return bytes([TYPE_ETH_CALL_RESPONSE]) + rlp.encode(
            [self.result, self.error])

    @classmethod
    def decode(cls, payload: bytes) -> "EthCallResponse":
        items = rlp.decode(payload)
        return cls(result=bytes(items[0]), error=bytes(items[1]))


def decode_message(blob: bytes):
    """Dispatch on the type tag."""
    tag, payload = blob[0], blob[1:]
    codec = {
        TYPE_LEAFS_REQUEST: LeafsRequest,
        TYPE_LEAFS_RESPONSE: LeafsResponse,
        TYPE_BLOCK_REQUEST: BlockRequest,
        TYPE_BLOCK_RESPONSE: BlockResponse,
        TYPE_CODE_REQUEST: CodeRequest,
        TYPE_CODE_RESPONSE: CodeResponse,
        TYPE_ETH_CALL_REQUEST: EthCallRequest,
        TYPE_ETH_CALL_RESPONSE: EthCallResponse,
    }.get(tag)
    if codec is None:
        raise ValueError(f"unknown message type {tag}")
    return codec.decode(payload)
