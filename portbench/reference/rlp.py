"""Recursive length prefix encoding, in plain Python."""

from __future__ import annotations


def _length(n: int, offset: int) -> bytes:
    if n <= 55:
        return bytes([offset + n])
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(b)]) + b


def encode(item) -> bytes:
    """bytes -> RLP string; int -> its minimal big-endian bytes; list or
    tuple -> RLP list."""
    if isinstance(item, int):
        item = item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        if len(item) == 1 and item[0] < 0x80:
            return bytes(item)
        return _length(len(item), 0x80) + bytes(item)
    payload = b"".join(encode(x) for x in item)
    return _length(len(payload), 0xC0) + payload


def decode(data: bytes):
    """The item that `data` encodes whole (bytes, or lists of items)."""
    item, end = _decode(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes after an RLP item")
    return item


def _decode(data: bytes, pos: int):
    b = data[pos]
    if b < 0x80:
        return data[pos:pos + 1], pos + 1
    if b < 0xB8:
        n = b - 0x80
        return data[pos + 1:pos + 1 + n], pos + 1 + n
    if b < 0xC0:
        k = b - 0xB7
        n = int.from_bytes(data[pos + 1:pos + 1 + k], "big")
        start = pos + 1 + k
        return data[start:start + n], start + n
    if b < 0xF8:
        n, start = b - 0xC0, pos + 1
    else:
        k = b - 0xF7
        n = int.from_bytes(data[pos + 1:pos + 1 + k], "big")
        start = pos + 1 + k
    out, p = [], start
    while p < start + n:
        item, p = _decode(data, p)
        out.append(item)
    if p != start + n:
        raise ValueError("an RLP list overruns its length")
    return out, p
