"""EIP-712 typed structured data signing (semantics of coreth signer/
core/apitypes — TypedData/Domain hashing as used by signTypedData);
counterpart of coreth_tpu/signer/__init__.py."""

from __future__ import annotations

from typing import Any, Dict, List

from ..accounts.abi import pack_values, parse_type
from ..native import keccak256


class TypedDataError(Exception):
    pass


def _type_dependencies(primary: str, types: Dict[str, list], found=None) -> List[str]:
    found = found if found is not None else []
    base = primary.split("[")[0]
    if base in found or base not in types:
        return found
    found.append(base)
    for f in types[base]:
        _type_dependencies(f["type"], types, found)
    return found


def encode_type(primary: str, types: Dict[str, list]) -> bytes:
    """encodeType: primary first, then deps alphabetically."""
    deps = _type_dependencies(primary, types)
    deps = [deps[0]] + sorted(deps[1:])
    out = ""
    for name in deps:
        fields = ",".join(f"{f['type']} {f['name']}" for f in types[name])
        out += f"{name}({fields})"
    return out.encode()


def type_hash(primary: str, types: Dict[str, list]) -> bytes:
    return keccak256(encode_type(primary, types))


def _encode_value(typ: str, value: Any, types: Dict[str, list]) -> bytes:
    base = typ.split("[")[0]
    if "[" in typ:
        inner = typ[: typ.rindex("[")]
        enc = b"".join(_encode_value(inner, v, types) for v in value)
        return keccak256(enc)
    if base in types:
        return hash_struct(base, value, types)
    if typ == "string":
        return keccak256(value.encode() if isinstance(value, str) else value)
    if typ == "bytes":
        return keccak256(bytes(value))
    t = parse_type(typ)
    return pack_values([t], [value])


def hash_struct(primary: str, data: Dict[str, Any], types: Dict[str, list]) -> bytes:
    """hashStruct = keccak(typeHash ‖ encodeData)."""
    enc = type_hash(primary, types)
    for f in types[primary]:
        enc += _encode_value(f["type"], data[f["name"]], types)
    return keccak256(enc)


EIP712_DOMAIN_FIELDS = [
    ("name", "string"),
    ("version", "string"),
    ("chainId", "uint256"),
    ("verifyingContract", "address"),
    ("salt", "bytes32"),
]


def domain_separator(domain: Dict[str, Any]) -> bytes:
    fields = [
        {"name": n, "type": t} for n, t in EIP712_DOMAIN_FIELDS if n in domain
    ]
    return hash_struct("EIP712Domain", domain, {"EIP712Domain": fields})


def typed_data_hash(domain: Dict[str, Any], primary: str,
                    types: Dict[str, list], message: Dict[str, Any]) -> bytes:
    """The final digest: keccak(0x1901 ‖ domainSeparator ‖ hashStruct(msg))."""
    return keccak256(
        b"\x19\x01" + domain_separator(domain) + hash_struct(primary, message, types)
    )


def sign_typed_data(priv: bytes, domain: Dict[str, Any], primary: str,
                    types: Dict[str, list], message: Dict[str, Any]) -> bytes:
    from ..crypto.secp256k1 import sign

    digest = typed_data_hash(domain, primary, types, message)
    v, r, s = sign(digest, priv)
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v + 27])
