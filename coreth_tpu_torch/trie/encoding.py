"""Trie key encodings (semantics of coreth trie/encoding.go).

Three forms:
  KEYBYTES: raw bytes, application-facing.
  HEX: one nibble per byte, optionally ending with the 0x10 terminator —
       in-memory form in Trie nodes.
  COMPACT (hex-prefix): nibbles packed two-per-byte with a flag nibble
       carrying oddness + terminator — the on-disk/RLP form.
"""

from __future__ import annotations

TERMINATOR = 0x10


def key_to_hex(key: bytes) -> bytes:
    """KEYBYTES -> HEX with terminator."""
    out = bytearray(len(key) * 2 + 1)
    for i, b in enumerate(key):
        out[2 * i] = b >> 4
        out[2 * i + 1] = b & 0x0F
    out[-1] = TERMINATOR
    return bytes(out)


def hex_to_keybytes(hexkey: bytes) -> bytes:
    """HEX (with or without terminator) -> KEYBYTES; must be even nibbles."""
    if has_term(hexkey):
        hexkey = hexkey[:-1]
    if len(hexkey) % 2:
        raise ValueError("can't convert odd-length hex key")
    out = bytearray(len(hexkey) // 2)
    for i in range(len(out)):
        out[i] = (hexkey[2 * i] << 4) | hexkey[2 * i + 1]
    return bytes(out)


def has_term(hexkey: bytes) -> bool:
    return bool(hexkey) and hexkey[-1] == TERMINATOR


def hex_to_compact(hexkey: bytes) -> bytes:
    terminator = 0
    if has_term(hexkey):
        terminator = 1
        hexkey = hexkey[:-1]
    out = bytearray(len(hexkey) // 2 + 1)
    out[0] = terminator << 5  # flag byte
    if len(hexkey) & 1:
        out[0] |= 1 << 4 | hexkey[0]  # odd flag + first nibble
        hexkey = hexkey[1:]
    for i in range(0, len(hexkey), 2):
        out[1 + i // 2] = (hexkey[i] << 4) | hexkey[i + 1]
    return bytes(out)


def compact_to_hex(compact: bytes) -> bytes:
    if not compact:
        return b""
    base = bytearray()
    for b in compact:
        base.append(b >> 4)
        base.append(b & 0x0F)
    # flags: base[0] bit1 = odd, bit2(value 2) = terminator
    chop = 2 - (base[0] & 1)
    out = bytes(base[chop:])
    if base[0] >= 2:
        out += bytes([TERMINATOR])
    return out


def prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n
