"""Experimental binary-Merkle commitment backend (COMMITMENT.md);
counterpart of coreth_tpu/bintrie.

A canonical sparse binary Merkle tree over 32-byte keccak-hashed keys:
fixed 2-ary fanout, uniform 64-byte internal nodes (``left || right``),
domain-separated 65-byte leaves (``0x00 || key || value_hash``). No RLP,
no variable fanout — the per-level digest matrix is a single dense
device array, which is exactly the shape the planned executor
(ops/keccak_planned.py) wants.

This package stays isolated from the MPT implementation in trie/: both
sit behind the CommitmentBackend seam (state/commitment.py). The planned
commit (planned.py) hashes on kernel K1 through the process DeviceLadder;
the dual-root shadow (shadow.py) is what the chain mounts.
"""

from .tree import (
    EMPTY,
    BinTrieMissingNode,
    BinaryTrie,
    NodeStore,
    internal_hash,
    leaf_hash,
    reference_root,
)
from .witness import WitnessError, absorb_witness, prove, verify_witness

__all__ = [
    "EMPTY",
    "BinTrieMissingNode",
    "BinaryTrie",
    "NodeStore",
    "WitnessError",
    "absorb_witness",
    "internal_hash",
    "leaf_hash",
    "prove",
    "reference_root",
    "verify_witness",
]
