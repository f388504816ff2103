"""Merkle proofs (semantics of coreth trie/proof.go); counterpart of
coreth_tpu/trie/proof.py.

prove() collects the node blobs along a key's path; verify_proof() walks
them from the root hash, raising ProofMissingNodeError for a blob the
proof lacks and ProofCorruptNodeError for one that does not hash to its
reference or does not decode (counted in trie/proof/missing_node and
trie/proof/corrupt_node). Range proofs live in proof_range.py. Proofs
hash on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..metrics import count_drop
from ..native import keccak256
from .encoding import key_to_hex
from .hasher import Hasher, node_to_bytes
from .node import (
    FullNode,
    HashNode,
    ProofCorruptNodeError,
    ProofMissingNodeError,
    ShortNode,
    ValueNode,
    must_decode_node,
)
from .trie import Trie


def prove(trie: Trie, key: bytes) -> List[bytes]:
    """Return the list of node blobs proving ``key`` (inclusion or absence)."""
    # ensure hashes are computed
    trie.hash()
    hexkey = key_to_hex(key)
    nodes = []
    n = trie.root
    prefix = b""
    while n is not None:
        if isinstance(n, HashNode):
            n = trie._resolve(n, prefix)
        if isinstance(n, ValueNode):
            break
        nodes.append(n)
        if isinstance(n, ShortNode):
            if len(hexkey) < len(n.key) or hexkey[: len(n.key)] != n.key:
                n = None
            else:
                prefix += n.key
                hexkey = hexkey[len(n.key):]
                n = n.val if not isinstance(n.val, ValueNode) else None
        elif isinstance(n, FullNode):
            if not hexkey:
                break
            prefix += hexkey[:1]
            n, hexkey = n.children[hexkey[0]], hexkey[1:]
    hasher = Hasher()
    proof = []
    for n in nodes:
        hashed, _ = hasher.hash(n, False)
        if isinstance(hashed, HashNode):
            # collapse with hashed children for the canonical blob
            proof.append(_encoded(n, hasher))
    return proof


def _encoded(n, hasher: Hasher) -> bytes:
    collapsed = hasher._collapse(n)
    return node_to_bytes(collapsed)


def verify_proof(root_hash: bytes, key: bytes, proof: Dict[bytes, bytes]) -> Optional[bytes]:
    """Verify a proof (dict hash->blob). Returns the value or None (proved
    absent). Raises ValueError on an invalid proof."""
    hexkey = key_to_hex(key)
    want = root_hash
    n = None
    while True:
        blob = proof.get(want)
        if blob is None:
            # typed absent-vs-corrupt split: an incomplete proof set is
            # refetch territory, a bad blob is peer misbehaviour
            count_drop("trie/proof/missing_node")
            raise ProofMissingNodeError(want, "verify_proof")
        if keccak256(blob) != want:
            count_drop("trie/proof/corrupt_node")
            raise ProofCorruptNodeError(want, "hash mismatch")
        try:
            n = must_decode_node(want, blob)
        except Exception as exc:
            count_drop("trie/proof/corrupt_node")
            raise ProofCorruptNodeError(want, f"undecodable: {exc}") from exc
        value, rest = _walk(n, hexkey, proof)
        if isinstance(rest, HashNode):
            want = bytes(rest)
            hexkey = value  # remaining key returned alongside
            continue
        return rest


def _walk(n, hexkey: bytes, proof) -> Tuple[Optional[bytes], object]:
    """Descend embedded nodes; returns (remaining_key, HashNode) to continue
    in the next proof blob, or (None, value_bytes|None) when resolved."""
    while True:
        if n is None:
            return None, None
        if isinstance(n, ValueNode):
            return None, bytes(n)
        if isinstance(n, HashNode):
            return hexkey, n
        if isinstance(n, ShortNode):
            if len(hexkey) < len(n.key) or hexkey[: len(n.key)] != n.key:
                return None, None
            hexkey = hexkey[len(n.key):]
            n = n.val
            continue
        if isinstance(n, FullNode):
            if not hexkey:
                n = n.children[16]
                continue
            n, hexkey = n.children[hexkey[0]], hexkey[1:]
            continue
        raise ValueError(f"invalid node {type(n)}")
