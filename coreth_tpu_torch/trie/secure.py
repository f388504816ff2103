"""Secure (keccak-keyed) trie — semantics of coreth trie/secure_trie.go;
counterpart of coreth_tpu/trie/secure.py.

All application keys are keccak256-hashed before hitting the trie, bounding
path depth to 64 nibbles and preventing DoS via deep keys. Preimages are
recorded optionally.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..native import keccak256
from .node import EMPTY_ROOT
from .trie import NodeReader, Trie


class StateTrie:
    def __init__(
        self,
        root: bytes = EMPTY_ROOT,
        reader: Optional[NodeReader] = None,
        batch_keccak=None,
        record_preimages: bool = False,
    ):
        self.trie = Trie(root, reader, batch_keccak)
        self._preimages: Dict[bytes, bytes] = {}
        self._record = record_preimages

    def hash_key(self, key: bytes) -> bytes:
        return keccak256(key)

    def get(self, key: bytes) -> Optional[bytes]:
        return self.trie.get(self.hash_key(key))

    def update(self, key: bytes, value: bytes) -> None:
        hk = self.hash_key(key)
        if self._record:
            self._preimages[hk] = key
        self.trie.update(hk, value)

    def delete(self, key: bytes) -> None:
        self.trie.delete(self.hash_key(key))

    def get_key(self, hashed: bytes) -> Optional[bytes]:
        return self._preimages.get(hashed)

    @property
    def preimages(self) -> Dict[bytes, bytes]:
        return self._preimages

    def hash(self) -> bytes:
        return self.trie.hash()

    def commit(self, collect_leaf: bool = False):
        return self.trie.commit(collect_leaf)

    def copy(self) -> "StateTrie":
        t = StateTrie.__new__(StateTrie)
        t.trie = self.trie.copy()
        t._preimages = dict(self._preimages)
        t._record = self._record
        return t
