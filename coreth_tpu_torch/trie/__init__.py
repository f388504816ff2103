"""Merkle-Patricia-Trie: the port's counterpart of coreth_tpu/trie."""

from .proof import prove, verify_proof
from .proof_range import has_right_element, proof_to_path, verify_range_proof

__all__ = [
    "has_right_element", "proof_to_path", "prove", "verify_proof",
    "verify_range_proof",
]
