"""Cryptography: the host keccak256 and secp256k1; counterpart of
coreth_tpu/crypto/__init__.py.

The reference also exports `keccak256_batch`, which its precompile and
proof consumers reach; those are ROADMAP "Still to port", item 9, and the
name is not exported until then.
"""

from ..native import keccak256
from .secp256k1 import (
    ecrecover,
    priv_to_address,
    pubkey,
    pubkey_to_address,
    recover_address,
    sign,
)

__all__ = [
    "ecrecover", "keccak256", "priv_to_address", "pubkey",
    "pubkey_to_address", "recover_address", "sign",
]
