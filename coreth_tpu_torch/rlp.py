"""RLP (Recursive Length Prefix) encoding/decoding.

The wire and storage serialization used throughout the framework — trie
nodes, transactions, blocks, receipts. Semantics match Ethereum's RLP spec
(reference uses github.com/ava-labs/coreth/rlp, a geth fork).

Values are bytes or (recursively) lists of values. Integers are encoded
big-endian with no leading zeros (helpers provided).
"""

from __future__ import annotations

from typing import Any, List, Tuple

__all__ = [
    "encode", "decode", "encode_uint", "decode_uint", "DecodeError",
    "split", "Kind", "KIND_BYTES", "KIND_LIST",
]


class DecodeError(Exception):
    pass


Kind = int
KIND_BYTES: Kind = 0
KIND_LIST: Kind = 1


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    blen = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(blen)]) + blen


def encode(item: Any) -> bytes:
    """Encode bytes / bytearray / int / list-of-those to RLP."""
    if isinstance(item, (bytes, bytearray, memoryview)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _encode_length(len(b), 0x80) + b
    if isinstance(item, int):
        return encode(int_to_bytes(item))
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def int_to_bytes(value: int) -> bytes:
    if value < 0:
        raise ValueError("RLP cannot encode negative integers")
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def encode_uint(value: int) -> bytes:
    return encode(int_to_bytes(value))


def decode_uint(b: bytes) -> int:
    if len(b) > 0 and b[0] == 0:
        raise DecodeError("leading zero in integer")
    return int.from_bytes(b, "big")


def split(data: bytes, pos: int = 0) -> Tuple[Kind, int, int, int]:
    """Parse one RLP item header at ``pos``.

    Returns (kind, payload_start, payload_len, total_len_from_pos).
    """
    if pos >= len(data):
        raise DecodeError("unexpected end of input")
    b0 = data[pos]
    if b0 < 0x80:
        return KIND_BYTES, pos, 1, 1
    if b0 < 0xB8:
        plen = b0 - 0x80
        start = pos + 1
        if plen == 1 and start < len(data) and data[start] < 0x80:
            raise DecodeError("non-canonical single byte")
        _check_bounds(data, start, plen)
        return KIND_BYTES, start, plen, 1 + plen
    if b0 < 0xC0:
        lenlen = b0 - 0xB7
        plen = _read_length(data, pos + 1, lenlen)
        start = pos + 1 + lenlen
        _check_bounds(data, start, plen)
        return KIND_BYTES, start, plen, 1 + lenlen + plen
    if b0 < 0xF8:
        plen = b0 - 0xC0
        start = pos + 1
        _check_bounds(data, start, plen)
        return KIND_LIST, start, plen, 1 + plen
    lenlen = b0 - 0xF7
    plen = _read_length(data, pos + 1, lenlen)
    start = pos + 1 + lenlen
    _check_bounds(data, start, plen)
    return KIND_LIST, start, plen, 1 + lenlen + plen


def _read_length(data: bytes, pos: int, lenlen: int) -> int:
    _check_bounds(data, pos, lenlen)
    if data[pos] == 0:
        raise DecodeError("leading zero in length")
    length = int.from_bytes(data[pos:pos + lenlen], "big")
    if length < 56:
        raise DecodeError("non-canonical length")
    return length


def _check_bounds(data: bytes, start: int, plen: int) -> None:
    if start + plen > len(data):
        raise DecodeError("value larger than input")


def _decode_at(data: bytes, pos: int):
    kind, start, plen, total = split(data, pos)
    if kind == KIND_BYTES:
        return data[start:start + plen], pos + total
    end = start + plen
    items: List[Any] = []
    p = start
    while p < end:
        item, p = _decode_at(data, p)
        items.append(item)
    if p != end:
        raise DecodeError("list payload overrun")
    return items, pos + total


def decode(data: bytes) -> Any:
    """Decode a single RLP item; raises DecodeError on trailing bytes."""
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise DecodeError(f"trailing bytes: {len(data) - end}")
    return item
