"""Dual-root shadow validation: a bintrie mounted beside the MPT;
counterpart of coreth_tpu/bintrie/shadow.py.

With state-backend "bintrie-shadow" the StateDB commit feeds every
account and storage write it flushes into a ShadowCommitment. The shadow
keeps its own binary-Merkle root per committed MPT root and runs three
independent divergence checks:

  1. replay determinism: committing the same (parent_root, new_root)
     transition twice must reproduce the same bintrie root (block
     building and block insertion both commit every block);
  2. advance: when the MPT root moved and the update set is non-empty,
     the bintrie root must move too;
  3. canonical rebuild: every `check_interval` commits, re-fold the full
     (key -> value_hash) map through tree.reference_root() and compare it
     with the incremental root.

A failed check, or an error of the shadow's own host code, QUARANTINES
the shadow: it stops updating, bumps `chain/commit/bintrie/quarantines`
and emits a `commitment/quarantine` flight event; the consensus (MPT)
root is never affected.

A commit of PLANNED_MIN_UPDATES updates or more hashes through the
planned executor (planned.commit_planned: kernel K1 on the shadow's
device, a dispatch of the process DeviceLadder); below that the host
keccak hashes it, a routing rule as in the reference. Where the port
differs (ROADMAP Queue 3): the reference hashes through
commit_with_fallback, which finishes a failed device commit on the host,
and turns any error into a quarantine. Here an error of the planned
commit (a device fault, a BuildError, DeviceWedgedError) is no
quarantine and no host re-hash: it propagates out of on_commit, so it
reaches insert_block / build_block, with the shadow's state as it was
before the commit (a retried block replays cleanly). While a caller has
the ladder demoted, the planned commit hashes on the host.

Roots are keyed by MPT root (content-addressed store + roots map), not by
a linear head, so reorgs and re-commits from older parents open the right
historical bintrie state.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..metrics import count_drop, default_registry
from ..native import keccak256
from .planned import commit_planned
from .tree import EMPTY, BinaryTrie, NodeStore, reference_root

ZERO32 = b"\x00" * 32

# below this many updates a commit hashes on the host: the planned
# executor pays a fixed dispatch and transfer cost per call, which only
# amortizes on bulk commits (the two are bit-exact, so this is a routing
# rule, the MPT's BATCH_THRESHOLD)
PLANNED_MIN_UPDATES = 64


def encode_account(nonce: int, balance: int, code_hash: bytes,
                   multicoin: bool) -> bytes:
    """Fixed-width bintrie account leaf payload (no RLP):
    nonce(8BE) || balance(32BE) || code_hash(32) || multicoin-flag(1)."""
    return (nonce.to_bytes(8, "big") + balance.to_bytes(32, "big")
            + code_hash + (b"\x01" if multicoin else b"\x00"))


def storage_key(addr_hash: bytes, slot_hash: bytes) -> bytes:
    """Single-tree storage addressing: storage lives in the same tree as
    the accounts under keccak256(addr_hash || slot_hash), so one commit
    hashes everything in one planned run."""
    return keccak256(addr_hash + slot_hash)


class ShadowCommitment:
    """The bintrie side of dual-root shadow validation.

    Updates arrive as tuples from the StateDB commit loop:

      ("account", addr_hash, (nonce, balance, code_hash, multicoin))
      ("storage", addr_hash, slot_hash, value32)   # ZERO32 -> delete
      ("destruct", addr_hash)                      # account + its slots

    `device` is the chain's device (None is CUDA) and `executor` the
    PlannedCommit the planned commits run on (default: that device's)."""

    def __init__(self, check_interval: int = 16,
                 note_event: Optional[Callable] = None, device=None,
                 executor=None):
        from ..ops.keccak_planned import default_planned_commit

        self.store = NodeStore()
        # mpt_root -> bintrie root for the same committed state
        self.roots: Dict[bytes, bytes] = {}
        # replay determinism: (parent_mpt, new_mpt) -> bintrie root
        self._seen: Dict[Tuple[bytes, bytes], bytes] = {}
        # bintrie storage keys alive per account, for destructs
        self._storage_keys: Dict[bytes, Set[bytes]] = {}
        # full key -> vhash map for the canonical-rebuild check
        self._content: Dict[bytes, bytes] = {}
        self._head_root: Optional[bytes] = None
        self.quarantined = False
        self.quarantine_reason: Optional[str] = None
        self.check_interval = check_interval
        self._commits = 0
        self._note_event = note_event
        self._anchored = False
        self.executor = (executor if executor is not None
                         else default_planned_commit(device))

    # ----------------------------------------------------------- queries

    def root_for(self, mpt_root: bytes) -> Optional[bytes]:
        """Bintrie root shadowing [mpt_root], or None if never seen."""
        return self.roots.get(mpt_root)

    def status(self) -> Dict[str, object]:
        return {
            "backend": "bintrie-shadow",
            "quarantined": self.quarantined,
            "quarantineReason": self.quarantine_reason,
            "commits": self._commits,
            "trackedRoots": len(self.roots),
            "storeNodes": len(self.store),
            "keys": len(self._content),
        }

    # ----------------------------------------------------------- commits

    def on_commit(self, parent_root: bytes, new_root: bytes,
                  updates: List[tuple], block_hash=None) -> Optional[bytes]:
        """Apply one MPT commit's update stream to the shadow. Returns the
        new bintrie root, or None (quarantined, or an unanchored parent).
        An error of the planned commit propagates (module docstring);
        any other failure quarantines the shadow."""
        if self.quarantined:
            return None
        try:
            staged = self._stage(parent_root, updates)
        except Exception as exc:  # noqa: BLE001 - the shadow must not leak
            return self._error(exc, block_hash)
        if staged is None:
            return None
        trie, content, keys, parent_broot = staged
        if len(updates) >= PLANNED_MIN_UPDATES:
            broot = commit_planned(trie, executor=self.executor)
        else:
            try:
                broot = trie.commit()
            except Exception as exc:  # noqa: BLE001
                return self._error(exc, block_hash)
        try:
            return self._settle(parent_root, new_root, updates, block_hash,
                                broot, parent_broot, content, keys)
        except Exception as exc:  # noqa: BLE001
            return self._error(exc, block_hash)

    def _error(self, exc: Exception, block_hash) -> None:
        count_drop("state/shadow/error")
        self._quarantine(f"shadow error: {exc!r}", block_hash)
        return None

    def _stage(self, parent_root, updates):
        """Open the parent's bintrie and apply `updates` to it, to a copy
        of the content map and to a copy-on-write view of the storage-key
        sets: (trie, content, keys, parent_broot), or None for a parent
        never shadowed after the anchor."""
        parent_broot = self.roots.get(parent_root)
        if parent_broot is None:
            if self._anchored:
                # a parent never shadowed (state loaded from disk): skip
                # rather than diverge on partial content
                default_registry.counter(
                    "chain/commit/bintrie/unanchored").inc()
                return None
            # the first commit anchors the shadow: the parent state is the
            # empty tree (genesis commits from an empty StateDB). Register
            # it so re-commits from the same parent stay anchored
            parent_broot = EMPTY
            self.roots[parent_root] = EMPTY
        self._anchored = True
        trie = BinaryTrie(self.store, parent_broot)
        content = (dict(self._content) if parent_root == self._head_root
                   else {k: vh for k, vh in trie.items()})
        keys: Dict[bytes, Set[bytes]] = {}
        for up in updates:
            self._apply(trie, content, keys, up)
        return trie, content, keys, parent_broot

    def _settle(self, parent_root, new_root, updates, block_hash, broot,
                parent_broot, content, keys):
        key = (parent_root, new_root)
        prev = self._seen.get(key)
        if prev is not None and prev != broot:
            self._quarantine(
                f"replay divergence: {prev.hex()[:16]} -> "
                f"{broot.hex()[:16]} for same transition", block_hash)
            return None
        if parent_root != new_root and updates and broot == parent_broot:
            self._quarantine(
                "advance divergence: mpt root moved, bintrie root did not",
                block_hash)
            return None

        self._seen[key] = broot
        self.roots[new_root] = broot
        self._content = content
        self._head_root = new_root
        for ah, s in keys.items():
            if s:
                self._storage_keys[ah] = s
            else:
                self._storage_keys.pop(ah, None)
        self._commits += 1

        if self.check_interval and self._commits % self.check_interval == 0:
            want = reference_root(content, hashed_values=True)
            if want != broot:
                self._quarantine(
                    f"rebuild divergence: incremental {broot.hex()[:16]} "
                    f"!= canonical {want.hex()[:16]}", block_hash)
                return None
        return broot

    def _keys_of(self, keys: Dict[bytes, Set[bytes]], ah: bytes) -> Set[bytes]:
        """The staged storage-key set of `ah` (copied on first touch)."""
        s = keys.get(ah)
        if s is None:
            s = keys[ah] = set(self._storage_keys.get(ah, ()))
        return s

    def _apply(self, trie, content, keys, up):
        kind = up[0]
        if kind == "account":
            _, ah, (nonce, balance, code_hash, multicoin) = up
            value = encode_account(nonce, balance, code_hash, multicoin)
            trie.update(ah, value)
            content[ah] = keccak256(value)
        elif kind == "storage":
            _, ah, hk, v = up
            bkey = storage_key(ah, hk)
            if v == ZERO32 or not v:
                trie.delete(bkey)
                content.pop(bkey, None)
                self._keys_of(keys, ah).discard(bkey)
            else:
                trie.update(bkey, v)
                content[bkey] = keccak256(v)
                self._keys_of(keys, ah).add(bkey)
        elif kind == "destruct":
            _, ah = up
            trie.delete(ah)
            content.pop(ah, None)
            s = self._keys_of(keys, ah)
            for bkey in sorted(s):
                trie.delete(bkey)
                content.pop(bkey, None)
            s.clear()
        else:
            raise ValueError(f"unknown shadow update kind {kind!r}")

    # -------------------------------------------------------- quarantine

    def _quarantine(self, why: str, block_hash=None) -> None:
        self.quarantined = True
        self.quarantine_reason = why
        default_registry.counter("chain/commit/bintrie/quarantines").inc()
        if self._note_event is not None:
            try:
                bh = block_hash.hex() if isinstance(block_hash, bytes) \
                    else block_hash
                self._note_event("commitment/quarantine", why=why,
                                 block=bh)
            except Exception:  # noqa: BLE001 - telemetry must not raise
                count_drop("state/shadow/event_error")
