"""Commitment-backend seam; counterpart of coreth_tpu/state/commitment.py.

A CommitmentBackend owns one commitment scheme (node layout, hashing,
proofs) and hands out CommitmentTrie views over committed roots;
state/database.py routes account-trie opens through the MPT backend, so
StateDB and the executors never name a concrete trie type.

Two implementations exist:

  * MPTBackend (here): the consensus Merkle-Patricia trie, including the
    resident mirror's roots;
  * BinTrieBackend (bintrie/backend.py): the binary Merkle tree, mounted
    only as the dual-root shadow (bintrie/shadow.py), never consensus.

trie/ and bintrie/ do not import each other; what they share goes
through this interface (or ops/, metrics/, native).

The reference's MPTBackend.prove hands the StateTrie itself to
trie/proof.prove, which reads `trie.root` and raises AttributeError, and
its verify passes the proof list where verify_proof wants a hash -> blob
map. The port proves over the StateTrie's inner Trie and builds the map
from the list (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..native import keccak256
from ..trie.node import EMPTY_ROOT

BACKEND_MPT = "mpt"
BACKEND_BINTRIE_SHADOW = "bintrie-shadow"
BACKENDS = (BACKEND_MPT, BACKEND_BINTRIE_SHADOW)


class CommitmentTrie:
    """One mutable view over a committed root. The MPT's StateTrie /
    MirrorStateTrie and the bintrie's BinaryTrie all satisfy this
    contract; it documents the duck typing at the seam."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def update(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def commit(self, collect_leaf: bool = False):
        raise NotImplementedError


class CommitmentBackend:
    """Factory + proof surface for one commitment scheme."""

    name: str = "?"

    def open(self, root: bytes):
        """CommitmentTrie over [root]."""
        raise NotImplementedError

    def empty_root(self) -> bytes:
        raise NotImplementedError

    def prove(self, root: bytes, key: bytes) -> List[bytes]:
        """Proof blob(s) for [key] against [root]; scheme-specific
        encoding, verifiable by verify()."""
        raise NotImplementedError

    def verify(self, root: bytes, key: bytes,
               proof: List[bytes]) -> Tuple[bool, Optional[bytes]]:
        """-> (present, value) after checking [proof] against [root];
        raises a scheme-specific error on malformed or tampered proofs."""
        raise NotImplementedError


class MPTBackend(CommitmentBackend):
    """Consensus Merkle-Patricia trie behind the seam: opens resolve
    through the TrieDatabase; when a ResidentAccountMirror is installed as
    `mirror`, roots the mirror holds open as device-resident facades
    (state/resident_trie.MirrorStateTrie).

    Proof keys are trie keys, as the bintrie backend's are: keccak256 of
    the address for the account trie. A resident root has no Python nodes
    to walk, so prove() first flushes the mirror's changed account nodes
    to disk at that root (ResidentAccountMirror.export_to, children first:
    the storage tries' dirty nodes are capped to disk before the account
    batch lands) and proves over the disk image, as the reference's
    eth/backend.walkable_state_trie does for eth_getProof. A resident root
    the mirror no longer reaches raises MirrorError."""

    name = BACKEND_MPT

    def __init__(self, triedb):
        self.triedb = triedb
        self.mirror = None  # the resident account mirror, when installed

    def open(self, root: bytes = EMPTY_ROOT):
        if self.mirror is not None and self.mirror.has_root(root):
            from .resident_trie import MirrorStateTrie

            return MirrorStateTrie(self.mirror, root, self.triedb)
        return self.triedb.open_state_trie(root)

    def empty_root(self) -> bytes:
        return EMPTY_ROOT

    def walkable(self, root: bytes):
        """A StateTrie at [root] with Python nodes to walk (class
        docstring: a resident root is exported to disk first)."""
        t = self.open(root)
        if not getattr(t, "resident", False):
            return t
        from ..trie.resident_mirror import MirrorError

        key = self.mirror.key_for_root(root)
        if key is None:
            raise MirrorError(
                f"root {root.hex()} left the resident window")
        triedb = self.triedb
        self.mirror.export_to(triedb.diskdb, at_block=key,
                              pre_write=lambda: triedb.cap(0))
        return triedb.open_state_trie(root)

    def prove(self, root: bytes, key: bytes) -> List[bytes]:
        from ..trie.proof import prove as mpt_prove

        return mpt_prove(self.walkable(root).trie, key)

    def verify(self, root: bytes, key: bytes,
               proof: List[bytes]) -> Tuple[bool, Optional[bytes]]:
        from ..trie.proof import verify_proof

        value = verify_proof(root, key, {keccak256(b): b for b in proof})
        return (value is not None, value)


def make_backend(name: str, triedb) -> CommitmentBackend:
    """Backend registry. "bintrie-shadow" still returns the MPT backend as
    the CONSENSUS backend: shadow mode mounts the bintrie beside it
    (core/blockchain.py mounts the ShadowCommitment); it never replaces
    the root the chain commits."""
    if name in (BACKEND_MPT, BACKEND_BINTRIE_SHADOW):
        return MPTBackend(triedb)
    raise ValueError(
        f"unknown state backend {name!r} (expected one of {BACKENDS})")
