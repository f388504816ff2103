"""State database wrapper (semantics of coreth core/state/database.go);
counterpart of coreth_tpu/state/database.py.

Opens account/storage tries against the TrieDatabase (which owns the batch
keccak every trie hashes with) and caches contract code read through rawdb.
`shadow` is the dual-root shadow (bintrie/shadow.ShadowCommitment) that
StateDB.commit feeds, None until a chain with state_backend
"bintrie-shadow" mounts one.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core import rawdb
from ..trie.node import EMPTY_ROOT
from ..trie.secure import StateTrie
from ..trie.triedb import TrieDatabase
from .commitment import MPTBackend

CODE_CACHE_LIMIT = 64 * 1024 * 1024


class Database:
    def __init__(self, triedb: TrieDatabase):
        self.triedb = triedb
        self.diskdb = triedb.diskdb
        # account-trie opens route through the commitment-backend seam;
        # the resident mirror installs onto backend.mirror (the `mirror`
        # property below)
        self.backend = MPTBackend(triedb)
        # the dual-root shadow, mounted by the chain for "bintrie-shadow";
        # it never affects the consensus (MPT) root
        self.shadow = None
        self._code_cache: Dict[bytes, bytes] = {}
        self._code_cache_size = 0

    @property
    def mirror(self):
        return self.backend.mirror

    @mirror.setter
    def mirror(self, m) -> None:
        self.backend.mirror = m

    def open_trie(self, root: bytes = EMPTY_ROOT):
        return self.backend.open(root)

    def open_storage_trie(self, addr_hash: bytes, root: bytes) -> StateTrie:
        # hashdb scheme: storage tries resolve by node hash, same namespace
        return self.triedb.open_state_trie(root)

    def contract_code(self, addr_hash: bytes, code_hash: bytes) -> Optional[bytes]:
        code = self._code_cache.get(code_hash)
        if code is not None:
            return code
        code = rawdb.read_code(self.diskdb, code_hash)
        if code is not None and self._code_cache_size < CODE_CACHE_LIMIT:
            self._code_cache[code_hash] = code
            self._code_cache_size += len(code)
        return code
