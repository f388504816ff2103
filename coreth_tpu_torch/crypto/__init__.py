"""Cryptography: the host keccak256 and its threaded batch form, and
secp256k1; counterpart of coreth_tpu/crypto/__init__.py."""

from ..native import keccak256, keccak256_batch
from .secp256k1 import (
    ecrecover,
    priv_to_address,
    pubkey,
    pubkey_to_address,
    recover_address,
    sign,
)

__all__ = [
    "ecrecover", "keccak256", "keccak256_batch", "priv_to_address",
    "pubkey", "pubkey_to_address", "recover_address", "sign",
]
