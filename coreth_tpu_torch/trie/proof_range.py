"""Range proofs (semantics of coreth trie/proof.go
VerifyRangeProof/proofToPath/unsetInternal/unset/hasRightElement);
counterpart of coreth_tpu/trie/proof_range.py.

Given a contiguous, sorted slice of (key, value) leaves plus Merkle proofs
for the two range edges, verify the slice is exactly the trie's content in
[first_key, last_key] and learn whether more leaves exist to the right —
the primitive under state-sync leaf batches (coreth
sync/handlers/leafs_request.go:374 builds these, sync/client/client.go:180
verifies them).

The algorithm: materialize both edge paths from the proof blobs into one
partial trie whose off-path children stay as opaque HashNodes; delete every
node strictly inside the range (they must be reconstructible from the
leaves alone); re-insert the leaf slice; the recomputed root must equal the
target. Completeness holds because any omitted/injected leaf changes some
node on the rebuilt fringe.
"""

from __future__ import annotations

from typing import List, Optional

from ..metrics import count_drop
from .encoding import key_to_hex
from .node import (
    EMPTY_ROOT,
    FullNode,
    HashNode,
    MissingNodeError,
    ProofCorruptNodeError,
    ProofError,
    ProofMissingNodeError,
    ShortNode,
    ValueNode,
    must_decode_node,
    new_flag,
)
from .stacktrie import StackTrie
from .trie import NodeReader, Trie

# the proof errors live in trie/node.py (shared with proof.py); named here
# for the importers of this module
__all_errors__ = (ProofError, ProofMissingNodeError, ProofCorruptNodeError)


def _resolve_from_proof(proof: dict, node_hash: bytes):
    blob = proof.get(node_hash)
    if blob is None:
        count_drop("trie/proof_range/missing_node")
        raise ProofMissingNodeError(node_hash, "range proof")
    try:
        return must_decode_node(node_hash, blob)
    except Exception as exc:
        count_drop("trie/proof_range/corrupt_node")
        raise ProofCorruptNodeError(
            node_hash, f"undecodable: {exc}") from exc


def _get(tn, key: bytes):
    """Walk to the next unresolved/terminal node (proof.go get, with
    skipResolved=False): returns (key_rest, child)."""
    while True:
        if isinstance(tn, ShortNode):
            if len(key) < len(tn.key) or tn.key != key[: len(tn.key)]:
                return None, None
            return key[len(tn.key):], tn.val
        if isinstance(tn, FullNode):
            return key[1:], tn.children[key[0]]
        if isinstance(tn, (HashNode, ValueNode)) or tn is None:
            return key, tn
        raise ProofError(f"invalid node {type(tn)}")


def proof_to_path(root_hash: bytes, root, key: bytes, proof: dict,
                  allow_non_existent: bool):
    """Materialize the path for [key] from proof blobs into [root]
    (proof.go proofToPath). Returns (root_node, value_or_None)."""
    if root is None:
        root = _resolve_from_proof(proof, root_hash)
    key = key_to_hex(key)
    parent = root
    while True:
        keyrest, child = _get(parent, key)
        if child is None:
            if keyrest is None or child is None:
                if allow_non_existent:
                    return root, None
                raise ProofError("the node is not contained in trie")
        if isinstance(child, (ShortNode, FullNode)):
            key, parent = keyrest, child
            continue
        valnode = None
        if isinstance(child, HashNode):
            child = _resolve_from_proof(proof, bytes(child))
        elif isinstance(child, ValueNode):
            valnode = bytes(child)
        # link into the parent
        if isinstance(parent, ShortNode):
            parent.val = child
        elif isinstance(parent, FullNode):
            parent.children[key[0]] = child
        if valnode is not None:
            return root, valnode
        key, parent = keyrest, child


def _unset(parent, child, key: bytes, pos: int, remove_left: bool) -> None:
    """proof.go unset: prune the in-range side of an edge path."""
    if isinstance(child, FullNode):
        if remove_left:
            for i in range(key[pos]):
                child.children[i] = None
        else:
            for i in range(key[pos] + 1, 16):
                child.children[i] = None
        child.flags = new_flag()
        _unset(child, child.children[key[pos]], key, pos + 1, remove_left)
        return
    if isinstance(child, ShortNode):
        if len(key[pos:]) < len(child.key) or child.key != key[pos: pos + len(child.key)]:
            # fork below the edge path: decide by ordering whether the
            # dangling branch is inside the range
            if remove_left:
                if child.key < key[pos:]:
                    parent.children[key[pos - 1]] = None
            else:
                if child.key > key[pos:]:
                    parent.children[key[pos - 1]] = None
            return
        if isinstance(child.val, ValueNode):
            parent.children[key[pos - 1]] = None
            return
        child.flags = new_flag()
        _unset(child, child.val, key, pos + len(child.key), remove_left)
        return
    if child is None:
        return
    raise ProofError("unexpected node in unset (hash/value)")


def _unset_internal(n, left_key: bytes, right_key: bytes) -> bool:
    """proof.go unsetInternal: remove every node strictly between the two
    edge paths. Returns True when the whole trie should be emptied."""
    left = key_to_hex(left_key)
    right = key_to_hex(right_key)
    pos = 0
    parent = None
    short_fork_left = short_fork_right = 0

    def cmp(a: bytes, b: bytes) -> int:
        return (a > b) - (a < b)

    while True:
        if isinstance(n, ShortNode):
            n.flags = new_flag()
            if len(left) - pos < len(n.key):
                short_fork_left = cmp(left[pos:], n.key)
            else:
                short_fork_left = cmp(left[pos: pos + len(n.key)], n.key)
            if len(right) - pos < len(n.key):
                short_fork_right = cmp(right[pos:], n.key)
            else:
                short_fork_right = cmp(right[pos: pos + len(n.key)], n.key)
            if short_fork_left != 0 or short_fork_right != 0:
                break
            parent = n
            n, pos = n.val, pos + len(n.key)
        elif isinstance(n, FullNode):
            n.flags = new_flag()
            leftnode = n.children[left[pos]]
            rightnode = n.children[right[pos]]
            if leftnode is None or rightnode is None or leftnode is not rightnode:
                break
            parent = n
            n, pos = n.children[left[pos]], pos + 1
        else:
            raise ProofError(f"invalid node at fork search: {type(n)}")

    if isinstance(n, ShortNode):
        if short_fork_left == -1 and short_fork_right == -1:
            raise ProofError("empty range")
        if short_fork_left == 1 and short_fork_right == 1:
            raise ProofError("empty range")
        if short_fork_left != 0 and short_fork_right != 0:
            if parent is None:
                return True
            parent.children[left[pos - 1]] = None
            return False
        if short_fork_right != 0:
            if isinstance(n.val, ValueNode):
                if parent is None:
                    return True
                parent.children[left[pos - 1]] = None
                return False
            _unset(n, n.val, left[pos:], len(n.key), False)
            return False
        if short_fork_left != 0:
            if isinstance(n.val, ValueNode):
                if parent is None:
                    return True
                parent.children[right[pos - 1]] = None
                return False
            _unset(n, n.val, right[pos:], len(n.key), True)
            return False
        return False
    if isinstance(n, FullNode):
        for i in range(left[pos] + 1, right[pos]):
            n.children[i] = None
        _unset(n, n.children[left[pos]], left[pos:], 1, False)
        _unset(n, n.children[right[pos]], right[pos:], 1, True)
        return False
    raise ProofError(f"invalid fork node {type(n)}")


def has_right_element(node, key: bytes) -> bool:
    """proof.go hasRightElement: any leaf right of [key] in the partial trie."""
    pos, key = 0, key_to_hex(key)
    while node is not None:
        if isinstance(node, FullNode):
            for i in range(key[pos] + 1, 16):
                if node.children[i] is not None:
                    return True
            node, pos = node.children[key[pos]], pos + 1
        elif isinstance(node, ShortNode):
            if len(key) - pos < len(node.key) or node.key != key[pos: pos + len(node.key)]:
                return node.key > key[pos:]
            node, pos = node.val, pos + len(node.key)
        elif isinstance(node, ValueNode):
            return False
        else:
            raise ProofError("unresolved node while checking right element")
    return False


def verify_range_proof(root_hash: bytes, first_key: bytes, last_key: bytes,
                       keys: List[bytes], values: List[bytes],
                       proof: Optional[dict]) -> bool:
    """VerifyRangeProof (proof.go): returns has_more (leaves exist right of
    the range); raises ProofError on an invalid proof.

    proof maps node hash → node blob, or None for a whole-trie proof.
    """
    if len(keys) != len(values):
        raise ProofError(f"inconsistent proof data: {len(keys)} keys, {len(values)} values")
    for i in range(len(keys) - 1):
        if keys[i] >= keys[i + 1]:
            raise ProofError("range is not monotonically increasing")
    for v in values:
        if len(v) == 0:
            raise ProofError("range contains deletion")

    # whole-trie proof: rebuild from scratch
    if proof is None:
        st = StackTrie()
        for k, v in zip(keys, values):
            st.update(k, v)
        if st.hash() != root_hash:
            raise ProofError("invalid proof: full-range root mismatch")
        return False

    # edge proof with zero keys: prove the trie has nothing at/after first
    if len(keys) == 0:
        root, val = proof_to_path(root_hash, None, first_key, proof, True)
        if val is not None or has_right_element(root, first_key):
            raise ProofError("more entries available")
        return False

    # one element, identical edges
    if len(keys) == 1 and first_key == last_key:
        root, val = proof_to_path(root_hash, None, first_key, proof, False)
        if first_key != keys[0]:
            raise ProofError("correct proof but invalid key")
        if val != values[0]:
            raise ProofError("correct proof but invalid data")
        return has_right_element(root, first_key)

    if first_key >= last_key:
        raise ProofError("invalid edge keys")
    if len(first_key) != len(last_key):
        raise ProofError("inconsistent edge key lengths")

    root, _ = proof_to_path(root_hash, None, first_key, proof, True)
    root, _ = proof_to_path(root_hash, root, last_key, proof, True)
    empty = _unset_internal(root, first_key, last_key)

    tr = Trie(EMPTY_ROOT, NodeReader({}))
    tr.root = None if empty else root
    try:
        for k, v in zip(keys, values):
            tr.update(k, v)
        got = tr.hash()
    except MissingNodeError as e:
        raise ProofError(f"invalid proof: dangling reference {e}") from e
    if got != root_hash:
        raise ProofError(
            f"invalid proof: want root {root_hash.hex()}, got {got.hex()}"
        )
    return has_right_element(tr.root, keys[-1])
