"""Contract ABI encoding/decoding (semantics of coreth accounts/abi/ —
type.go/argument.go/pack.go/unpack.go/event.go/method.go); counterpart of
coreth_tpu/accounts/abi.py.

Supports the full static/dynamic type grammar: uint<N>/int<N>, address,
bool, bytes<N>, bytes, string, fixed arrays T[k], dynamic arrays T[],
and tuples (components). Selector computation and event topic hashing
follow the canonical signature rules (method.go Sig/ID).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..native import keccak256


class ABIError(Exception):
    pass


# --- type model -----------------------------------------------------------


@dataclass
class ABIType:
    kind: str                       # uint,int,address,bool,bytesN,bytes,string,array,slice,tuple
    size: int = 0                   # bits for uint/int, bytes for bytesN, length for array
    elem: Optional["ABIType"] = None
    components: List[Tuple[str, "ABIType"]] = field(default_factory=list)

    @property
    def is_dynamic(self) -> bool:
        if self.kind in ("bytes", "string", "slice"):
            return True
        if self.kind == "array":
            return self.elem.is_dynamic
        if self.kind == "tuple":
            return any(t.is_dynamic for _, t in self.components)
        return False

    def canonical(self) -> str:
        if self.kind in ("uint", "int"):
            return f"{self.kind}{self.size}"
        if self.kind == "bytesN":
            return f"bytes{self.size}"
        if self.kind == "array":
            return f"{self.elem.canonical()}[{self.size}]"
        if self.kind == "slice":
            return f"{self.elem.canonical()}[]"
        if self.kind == "tuple":
            return "(" + ",".join(t.canonical() for _, t in self.components) + ")"
        return self.kind


_ARRAY_RE = re.compile(r"^(.*)\[(\d*)\]$")


def parse_type(s: str, components: Optional[list] = None) -> ABIType:
    """type.go NewType."""
    m = _ARRAY_RE.match(s)
    if m:
        elem = parse_type(m.group(1), components)
        if m.group(2):
            return ABIType("array", size=int(m.group(2)), elem=elem)
        return ABIType("slice", elem=elem)
    if s == "tuple":
        comps = [
            (c["name"], parse_type(c["type"], c.get("components")))
            for c in (components or [])
        ]
        return ABIType("tuple", components=comps)
    if s == "address":
        return ABIType("address")
    if s == "bool":
        return ABIType("bool")
    if s == "string":
        return ABIType("string")
    if s == "bytes":
        return ABIType("bytes")
    if s == "function":
        return ABIType("bytesN", size=24)
    m = re.match(r"^uint(\d+)?$", s)
    if m:
        return ABIType("uint", size=int(m.group(1) or 256))
    m = re.match(r"^int(\d+)?$", s)
    if m:
        return ABIType("int", size=int(m.group(1) or 256))
    m = re.match(r"^bytes(\d+)$", s)
    if m:
        n = int(m.group(1))
        if not 1 <= n <= 32:
            raise ABIError(f"invalid bytes{n}")
        return ABIType("bytesN", size=n)
    raise ABIError(f"unsupported type {s}")


# --- packing --------------------------------------------------------------


def _pack_head(t: ABIType, v: Any) -> bytes:
    if t.kind == "uint":
        if not 0 <= v < (1 << t.size):
            raise ABIError(f"uint{t.size} out of range: {v}")
        return v.to_bytes(32, "big")
    if t.kind == "int":
        lo, hi = -(1 << (t.size - 1)), (1 << (t.size - 1)) - 1
        if not lo <= v <= hi:
            raise ABIError(f"int{t.size} out of range: {v}")
        return (v & ((1 << 256) - 1)).to_bytes(32, "big")
    if t.kind == "address":
        if len(v) != 20:
            raise ABIError("address must be 20 bytes")
        return v.rjust(32, b"\x00")
    if t.kind == "bool":
        return (1 if v else 0).to_bytes(32, "big")
    if t.kind == "bytesN":
        if len(v) != t.size:
            raise ABIError(f"bytes{t.size} got {len(v)}")
        return v.ljust(32, b"\x00")
    raise ABIError(f"not a static head type {t.kind}")


def _pack(t: ABIType, v: Any) -> bytes:
    """Encoded bytes for one value (without outer offset)."""
    if t.kind in ("uint", "int", "address", "bool", "bytesN"):
        return _pack_head(t, v)
    if t.kind in ("bytes", "string"):
        data = v.encode() if isinstance(v, str) else bytes(v)
        padded = data.ljust((len(data) + 31) // 32 * 32, b"\x00")
        return len(data).to_bytes(32, "big") + padded
    if t.kind == "slice":
        body = pack_values([t.elem] * len(v), list(v))
        return len(v).to_bytes(32, "big") + body
    if t.kind == "array":
        if len(v) != t.size:
            raise ABIError(f"array length {len(v)} != {t.size}")
        return pack_values([t.elem] * t.size, list(v))
    if t.kind == "tuple":
        return pack_values([ty for _, ty in t.components], list(v))
    raise ABIError(f"cannot pack {t.kind}")


def pack_values(types: List[ABIType], values: List[Any]) -> bytes:
    """argument.go Pack: head/tail encoding."""
    if len(types) != len(values):
        raise ABIError("argument count mismatch")
    heads: List[bytes] = []
    tails: List[bytes] = []
    head_size = sum(
        32 if t.is_dynamic or t.kind not in ("array", "tuple")
        else len(_pack(t, v))
        for t, v in zip(types, values)
    )
    offset = head_size
    for t, v in zip(types, values):
        if t.is_dynamic:
            heads.append(offset.to_bytes(32, "big"))
            tail = _pack(t, v)
            tails.append(tail)
            offset += len(tail)
        else:
            heads.append(_pack(t, v))
    return b"".join(heads) + b"".join(tails)


# --- unpacking ------------------------------------------------------------


def _unpack(t: ABIType, data: bytes, offset: int) -> Tuple[Any, int]:
    """Returns (value, head_size_consumed)."""
    if t.kind == "uint":
        return int.from_bytes(data[offset:offset + 32], "big"), 32
    if t.kind == "int":
        v = int.from_bytes(data[offset:offset + 32], "big")
        if v >= 1 << 255:
            v -= 1 << 256
        return v, 32
    if t.kind == "address":
        return data[offset + 12:offset + 32], 32
    if t.kind == "bool":
        return data[offset + 31] != 0, 32
    if t.kind == "bytesN":
        return data[offset:offset + t.size], 32
    if t.kind in ("bytes", "string"):
        loc = int.from_bytes(data[offset:offset + 32], "big")
        n = int.from_bytes(data[loc:loc + 32], "big")
        raw = data[loc + 32:loc + 32 + n]
        return (raw.decode() if t.kind == "string" else raw), 32
    if t.kind == "slice":
        loc = int.from_bytes(data[offset:offset + 32], "big")
        n = int.from_bytes(data[loc:loc + 32], "big")
        vals = unpack_values([t.elem] * n, data[loc + 32:])
        return vals, 32
    if t.kind == "array":
        if t.is_dynamic:
            loc = int.from_bytes(data[offset:offset + 32], "big")
            return unpack_values([t.elem] * t.size, data[loc:]), 32
        vals = []
        off = offset
        for _ in range(t.size):
            v, used = _unpack(t.elem, data, off)
            vals.append(v)
            off += used
        return vals, off - offset
    if t.kind == "tuple":
        types = [ty for _, ty in t.components]
        if t.is_dynamic:
            loc = int.from_bytes(data[offset:offset + 32], "big")
            return tuple(unpack_values(types, data[loc:])), 32
        vals = []
        off = offset
        for ty in types:
            v, used = _unpack(ty, data, off)
            vals.append(v)
            off += used
        return tuple(vals), off - offset
    raise ABIError(f"cannot unpack {t.kind}")


def unpack_values(types: List[ABIType], data: bytes) -> List[Any]:
    out = []
    offset = 0
    for t in types:
        v, used = _unpack(t, data, offset)
        out.append(v)
        offset += used
    return out


# --- ABI container --------------------------------------------------------


@dataclass
class Method:
    name: str
    inputs: List[Tuple[str, ABIType]]
    outputs: List[Tuple[str, ABIType]]
    state_mutability: str = "nonpayable"

    def sig(self) -> str:
        return f"{self.name}({','.join(t.canonical() for _, t in self.inputs)})"

    def selector(self) -> bytes:
        return keccak256(self.sig().encode())[:4]


@dataclass
class Event:
    name: str
    inputs: List[Tuple[str, ABIType, bool]]  # (name, type, indexed)
    anonymous: bool = False

    def sig(self) -> str:
        return f"{self.name}({','.join(t.canonical() for _, t, _ in self.inputs)})"

    def topic(self) -> bytes:
        return keccak256(self.sig().encode())


class ABI:
    """abi.go ABI: parsed from the standard JSON."""

    def __init__(self, json_abi: list):
        self.methods: dict = {}
        self.events: dict = {}
        self.constructor: Optional[Method] = None
        for entry in json_abi:
            typ = entry.get("type", "function")
            if typ == "function":
                m = Method(
                    entry["name"],
                    [(i.get("name", ""), parse_type(i["type"], i.get("components")))
                     for i in entry.get("inputs", [])],
                    [(o.get("name", ""), parse_type(o["type"], o.get("components")))
                     for o in entry.get("outputs", [])],
                    entry.get("stateMutability", "nonpayable"),
                )
                self.methods[m.name] = m
            elif typ == "event":
                e = Event(
                    entry["name"],
                    [(i.get("name", ""), parse_type(i["type"], i.get("components")),
                      i.get("indexed", False))
                     for i in entry.get("inputs", [])],
                    entry.get("anonymous", False),
                )
                self.events[e.name] = e
            elif typ == "constructor":
                self.constructor = Method(
                    "", [(i.get("name", ""), parse_type(i["type"], i.get("components")))
                         for i in entry.get("inputs", [])], [],
                )

    def pack(self, name: str, *args) -> bytes:
        m = self.methods[name]
        return m.selector() + pack_values([t for _, t in m.inputs], list(args))

    def unpack(self, name: str, data: bytes) -> List[Any]:
        m = self.methods[name]
        return unpack_values([t for _, t in m.outputs], data)

    def decode_log(self, name: str, topics: List[bytes], data: bytes) -> dict:
        """event.go/unpack.go UnpackLog: indexed from topics, rest from data."""
        e = self.events[name]
        out = {}
        ti = 0 if e.anonymous else 1
        data_types = []
        data_names = []
        for nm, t, indexed in e.inputs:
            if indexed:
                if t.is_dynamic:
                    out[nm] = topics[ti]  # dynamic indexed: only the hash
                else:
                    out[nm], _ = _unpack(t, topics[ti], 0)
                ti += 1
            else:
                data_types.append(t)
                data_names.append(nm)
        for nm, v in zip(data_names, unpack_values(data_types, data)):
            out[nm] = v
        return out
