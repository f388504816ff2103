"""Commitment-backend seam; counterpart of coreth_tpu/state/commitment.py.

A commitment backend owns one commitment scheme and hands out trie views
over committed roots; state/database.py routes account-trie opens through
it. The port has the consensus Merkle-Patricia trie, MPTBackend. The
backend interface, the binary-trie backend and its dual-root shadow, the
backend registry and the proof surface are not ported (ROADMAP "Still to
port", items 9 and 10).
"""

from __future__ import annotations

from ..trie.node import EMPTY_ROOT

BACKEND_MPT = "mpt"


class MPTBackend:
    """Consensus Merkle-Patricia trie behind the seam: opens resolve
    through the TrieDatabase; when a ResidentAccountMirror is installed as
    `mirror`, roots the mirror holds open as device-resident facades
    (state/resident_trie.MirrorStateTrie)."""

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
