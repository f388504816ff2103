"""BinTrieBackend: the binary-Merkle side of the commitment seam;
counterpart of coreth_tpu/bintrie/backend.py.

Satisfies the CommitmentBackend contract (state/commitment.py) without
importing it: the seam module knows both implementations, the
implementations only the duck-typed contract (this package and trie/ do
not import each other). Proofs here are single-blob compact witnesses
(witness.py), not MPT node lists; verify() returns the same (present,
value) shape.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .tree import EMPTY, BinaryTrie, NodeStore
from .witness import prove as witness_prove
from .witness import verify_witness


class BinTrieBackend:
    name = "bintrie"

    def __init__(self, store: Optional[NodeStore] = None):
        self.store = store if store is not None else NodeStore()

    def open(self, root: bytes = EMPTY) -> BinaryTrie:
        return BinaryTrie(self.store, root)

    def empty_root(self) -> bytes:
        return EMPTY

    def prove(self, root: bytes, key: bytes) -> List[bytes]:
        # one self-contained witness blob; a list for seam symmetry
        return [witness_prove(self.store, root, key)]

    def verify(self, root: bytes, key: bytes,
               proof: List[bytes]) -> Tuple[bool, Optional[bytes]]:
        if len(proof) != 1:
            from .witness import WitnessError

            raise WitnessError(
                f"bintrie proofs are one witness blob (got {len(proof)})")
        return verify_witness(root, key, proof[0])
