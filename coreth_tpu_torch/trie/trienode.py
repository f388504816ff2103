"""Dirty-node transfer types between Trie.commit and the trie database.

Semantics of coreth trie/trienode/node.go: a NodeSet carries the
nodes produced by one trie commit, keyed by path, for merging into the
in-memory dirty forest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class Node:
    __slots__ = ("hash", "blob")

    def __init__(self, hash: bytes, blob: bytes):
        self.hash = hash
        self.blob = blob

    @property
    def is_deleted(self) -> bool:
        return len(self.blob) == 0


class NodeSet:
    """Nodes from a single commit, keyed by hex path (no terminator)."""

    def __init__(self, owner: bytes = b""):
        self.owner = owner  # b"" for the account trie, storage root otherwise
        self.nodes: Dict[bytes, Node] = {}
        self.leaves: List[Tuple[bytes, bytes]] = []  # (parent hash, blob)
        self.updates = 0
        self.deletes = 0

    def add_node(self, path: bytes, node: Node) -> None:
        if node.is_deleted:
            self.deletes += 1
        else:
            self.updates += 1
        self.nodes[path] = node

    def add_leaf(self, parent: bytes, blob: bytes) -> None:
        self.leaves.append((parent, blob))

    def __len__(self) -> int:
        return len(self.nodes)


class MergedNodeSet:
    """NodeSets from many tries (account + storages), keyed by owner."""

    def __init__(self):
        self.sets: Dict[bytes, NodeSet] = {}

    def merge(self, other: Optional[NodeSet]) -> None:
        if other is None:
            return
        existing = self.sets.get(other.owner)
        if existing is None:
            self.sets[other.owner] = other
            return
        for path, node in other.nodes.items():
            existing.add_node(path, node)
        existing.leaves.extend(other.leaves)

    def flatten(self) -> Dict[bytes, Dict[bytes, Node]]:
        return {owner: s.nodes for owner, s in self.sets.items()}
