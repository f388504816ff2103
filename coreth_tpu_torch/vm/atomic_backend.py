"""Per-verified-block pending atomic state + the atomic tx repository
(semantics of coreth plugin/evm/atomic_backend.go, atomic_state.go,
atomic_tx_repository.go); counterpart of coreth_tpu/vm/atomic_backend.py.

At VERIFY time every block gets an `AtomicState` capturing its atomic
txs' shared-memory requests and the UTXO ids they consume; insertion
checks the block's consumed set against every PENDING (verified, not yet
accepted) ancestor so one unaccepted chain can never double-spend a
UTXO internally — the check the reference performs in
atomic_backend.InsertTxs. Accept applies the precomputed requests to
shared memory atomically with the repository index batch and drops the
pending state; Reject just drops it.

The repository indexes accepted atomic txs BOTH by tx id and by height
(atomic_tx_repository.go), and ships the bonus-block repair: mainnet
"bonus blocks" were accepted twice at different heights, leaving their
txs double-indexed; `repair_bonus_blocks` drops the bonus-height index
rows whose txs are already indexed at their canonical (lowest) height.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

TX_INDEX_PREFIX = b"Atx"      # Atx + tx_id -> height(8) + tx bytes
HEIGHT_INDEX_PREFIX = b"Ath"  # Ath + height(8) -> concat of 32-byte tx ids


class AtomicBackendError(Exception):
    pass


class AtomicState:
    """Pending atomic effects of ONE verified block (atomic_state.go)."""

    def __init__(self, block_hash: bytes, parent_hash: bytes, height: int,
                 txs: List, ops: Dict[bytes, object], consumed: Set[bytes]):
        self.block_hash = block_hash
        self.parent_hash = parent_hash
        self.height = height
        self.txs = txs
        self.ops = ops              # chain_id -> Requests
        self.consumed = consumed    # UTXO ids spent by this block


class AtomicTxRepository:
    """Height + id indexes over accepted atomic txs
    (atomic_tx_repository.go)."""

    def __init__(self, diskdb):
        self.diskdb = diskdb

    def write(self, batch, height: int, txs: List) -> None:
        ids = b""
        for tx in txs:
            batch.put(TX_INDEX_PREFIX + tx.id(),
                      height.to_bytes(8, "big") + tx.encode())
            ids += tx.id()
        if ids:
            batch.put(HEIGHT_INDEX_PREFIX + height.to_bytes(8, "big"), ids)

    def get_by_id(self, tx_id: bytes) -> Optional[Tuple[int, bytes]]:
        blob = self.diskdb.get(TX_INDEX_PREFIX + tx_id)
        if blob is None:
            return None
        return int.from_bytes(blob[:8], "big"), blob[8:]

    def tx_ids_at_height(self, height: int) -> List[bytes]:
        blob = self.diskdb.get(
            HEIGHT_INDEX_PREFIX + height.to_bytes(8, "big"))
        if not blob:
            return []
        return [blob[i:i + 32] for i in range(0, len(blob), 32)]

    def iterate_heights(self):
        for k, blob in self.diskdb.iterate(prefix=HEIGHT_INDEX_PREFIX):
            height = int.from_bytes(k[len(HEIGHT_INDEX_PREFIX):], "big")
            yield height, [blob[i:i + 32] for i in range(0, len(blob), 32)]

    def repair_bonus_blocks(self, bonus_heights: Set[int]) -> int:
        """Drop height-index rows for bonus blocks whose txs are already
        canonically indexed at a LOWER height; re-point the tx index at
        the canonical height. Returns rows repaired. Idempotent."""
        repaired = 0
        batch = self.diskdb.new_batch()
        for height in sorted(bonus_heights):
            ids = self.tx_ids_at_height(height)
            if not ids:
                continue
            all_dupe = True
            for tx_id in ids:
                entry = self.get_by_id(tx_id)
                if entry is None:
                    all_dupe = False
                    continue
                canonical = self._lowest_height_of(tx_id, height)
                if canonical is None or canonical >= height:
                    all_dupe = False
                    continue
                # keep the tx body; re-point its height at the canonical one
                _, tx_bytes = entry
                batch.put(TX_INDEX_PREFIX + tx_id,
                          canonical.to_bytes(8, "big") + tx_bytes)
            if all_dupe:
                batch.delete(HEIGHT_INDEX_PREFIX + height.to_bytes(8, "big"))
                repaired += 1
        batch.write()
        return repaired

    def _lowest_height_of(self, tx_id: bytes, below: int) -> Optional[int]:
        best = None
        for height, ids in self.iterate_heights():
            if height >= below:
                break
            if tx_id in ids:
                best = height if best is None else min(best, height)
        return best


class AtomicBackend:
    """Pending-state manager keyed by block hash (atomic_backend.go)."""

    def __init__(self, vm):
        self.vm = vm
        self.repo = AtomicTxRepository(vm.blockchain.diskdb)
        self._pending: Dict[bytes, AtomicState] = {}
        self._lock = threading.Lock()

    # --- verify -----------------------------------------------------------

    def insert_block(self, vmb) -> AtomicState:
        """Build the block's pending atomic state; reject UTXO
        double-spends against pending ancestors."""
        ops: Dict[bytes, object] = {}
        consumed: Set[bytes] = set()
        for tx in vmb.atomic_txs:
            chain, requests = tx.atomic_ops()
            if chain in ops:
                ops[chain].remove_requests.extend(requests.remove_requests)
                ops[chain].put_requests.extend(requests.put_requests)
            else:
                from .shared_memory import Requests

                ops[chain] = Requests(list(requests.remove_requests),
                                      list(requests.put_requests))
            for uid in getattr(tx.unsigned, "input_utxos", lambda: [])():
                consumed.add(uid)

        parent = vmb.eth_block.parent_hash
        with self._lock:
            anc = self._pending.get(parent)
            while anc is not None:
                overlap = consumed & anc.consumed
                if overlap:
                    raise AtomicBackendError(
                        "conflicting atomic inputs with pending ancestor "
                        f"{anc.block_hash.hex()[:12]}"
                    )
                anc = self._pending.get(anc.parent_hash)
            st = AtomicState(vmb.id(), parent, vmb.height(), list(vmb.atomic_txs),
                             ops, consumed)
            self._pending[vmb.id()] = st
        return st

    # --- accept / reject ---------------------------------------------------

    def accept(self, vmb) -> None:
        """Apply the precomputed requests + repository rows in ONE batch
        with the shared-memory commit (block.go:164-168 versiondb shape)."""
        with self._lock:
            st = self._pending.pop(vmb.id(), None)
        if st is None:
            # re-derive for blocks verified before this backend existed
            st = self.insert_block(vmb)
            with self._lock:
                self._pending.pop(vmb.id(), None)
        batch = self.vm.blockchain.diskdb.new_batch()
        self.repo.write(batch, st.height, st.txs)
        if st.ops:
            self.vm.shared_memory.apply(st.ops, batch=batch)
        else:
            batch.write()
        for tx in st.txs:
            self.vm.mempool.remove_tx(tx)
        if st.ops:
            self.vm.atomic_trie.index(st.height, st.ops)

    def reject(self, vmb) -> None:
        with self._lock:
            self._pending.pop(vmb.id(), None)

    def pending_for(self, block_hash: bytes) -> Optional[AtomicState]:
        with self._lock:
            return self._pending.get(block_hash)
