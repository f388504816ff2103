"""State-change journal (semantics of coreth core/state/journal.go);
counterpart of coreth_tpu/state/journal.py.

Every mutation appends an undo entry; Snapshot marks a length, RevertToSnapshot
unwinds entries above the mark in reverse. Entries are (revert_fn, dirtied
address) pairs; the dirties counter drives Finalise's dirty-object set.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


class Journal:
    def __init__(self):
        self.entries: List[Tuple[Callable, Optional[bytes]]] = []
        self.dirties: Dict[bytes, int] = {}

    def append(self, revert: Callable, dirtied: Optional[bytes] = None) -> None:
        self.entries.append((revert, dirtied))
        if dirtied is not None:
            self.dirties[dirtied] = self.dirties.get(dirtied, 0) + 1

    def revert(self, db, snapshot: int) -> None:
        for i in range(len(self.entries) - 1, snapshot - 1, -1):
            revert, dirtied = self.entries[i]
            revert(db)
            if dirtied is not None:
                n = self.dirties[dirtied] - 1
                if n == 0:
                    del self.dirties[dirtied]
                else:
                    self.dirties[dirtied] = n
        del self.entries[snapshot:]

    def length(self) -> int:
        return len(self.entries)
