"""Atomic-tx mempool (semantics of coreth plugin/evm/mempool.go +
tx_heap.go): price heap by gas price, UTXO-conflict tracking, discarded
LRU, pending signal. Counterpart of coreth_tpu/vm/mempool.py."""

from __future__ import annotations

import heapq
import threading
from collections import OrderedDict
from typing import Dict, Optional

from .atomic_tx import Tx

DISCARDED_CACHE_SIZE = 50


class MempoolError(Exception):
    pass


ErrTooManyAtomicTx = "too many pending atomic txs"
ErrConflictingAtomicTx = "conflicting atomic tx present"
ErrAlreadyKnown = "already known"


class Mempool:
    def __init__(self, max_size: int = 4096, fee_fn=None, max_tx_gas=None):
        self.mu = threading.RLock()
        self.max_size = max_size
        self.fee_fn = fee_fn  # tx -> gas price (nAVAX/gas); default burned/gas
        # per-tx gas cap (AP5 atomic gas limit): a tx that can never fit in
        # a block must be rejected at admission or it starves the heap
        self.max_tx_gas = max_tx_gas  # callable: tx -> bool (fits)

        self.tx_heap: list = []  # (-price, seq, tx_id)
        self._seq = 0
        self.txs: Dict[bytes, Tx] = {}
        self.prices: Dict[bytes, int] = {}
        self.issued: Dict[bytes, Tx] = {}     # currently in a building block
        self.utxo_spenders: Dict[bytes, bytes] = {}  # utxo_id -> tx_id
        self.discarded: "OrderedDict[bytes, Tx]" = OrderedDict()
        self.pending_signal = threading.Event()

    def _price(self, tx: Tx) -> int:
        if self.fee_fn is not None:
            return self.fee_fn(tx)
        gas = max(tx.gas_used(True), 1)
        burned = max(tx.burned(b"\x00" * 32), 0)
        # default ordering: burned-per-gas; VM injects the real asset id
        return burned // gas

    def add(self, tx: Tx, force: bool = False) -> None:
        with self.mu:
            tx_id = tx.id()
            if tx_id in self.txs or tx_id in self.issued:
                raise MempoolError(ErrAlreadyKnown)
            if tx_id in self.discarded and not force:
                raise MempoolError(ErrAlreadyKnown)
            if len(self.txs) >= self.max_size:
                raise MempoolError(ErrTooManyAtomicTx)
            if self.max_tx_gas is not None and not self.max_tx_gas(tx):
                raise MempoolError("atomic tx exceeds atomic gas limit")
            price = self._price(tx)
            # conflict: collect ALL conflicting spenders first, compare
            # against the highest-priced one, only then evict (mempool.go —
            # a rejected add must not mutate the pool)
            conflicts = {
                self.utxo_spenders[u]
                for u in tx.input_utxos()
                if u in self.utxo_spenders
            }
            if conflicts:
                max_price = max(self.prices.get(c, 0) for c in conflicts)
                if max_price >= price and not force:
                    raise MempoolError(ErrConflictingAtomicTx)
                for other in conflicts:
                    self._remove(other)
            self.txs[tx_id] = tx
            self.prices[tx_id] = price
            self.discarded.pop(tx_id, None)
            for utxo in tx.input_utxos():
                self.utxo_spenders[utxo] = tx_id
            heapq.heappush(self.tx_heap, (-price, self._seq, tx_id))
            self._seq += 1
            self.pending_signal.set()

    def _remove(self, tx_id: bytes) -> None:  # guarded-by: mu
        tx = self.txs.pop(tx_id, None)
        self.prices.pop(tx_id, None)
        if tx is not None:
            for utxo in tx.input_utxos():
                if self.utxo_spenders.get(utxo) == tx_id:
                    del self.utxo_spenders[utxo]

    def next_tx(self) -> Optional[Tx]:
        """Pop the best-priced pending tx, marking it issued."""
        with self.mu:
            while self.tx_heap:
                _, _, tx_id = heapq.heappop(self.tx_heap)
                tx = self.txs.get(tx_id)
                if tx is None:
                    continue
                self._remove(tx_id)
                self.issued[tx_id] = tx
                return tx
            self.pending_signal.clear()
            return None

    def cancel_current_tx(self, tx_id: bytes) -> None:
        """Issued tx didn't make it into a block: requeue."""
        with self.mu:
            tx = self.issued.pop(tx_id, None)
            if tx is not None:
                try:
                    self.add(tx, force=True)
                except MempoolError:
                    pass

    def issue_current_txs(self) -> None:
        """Issued txs made it into the preferred block."""
        with self.mu:
            self.issued.clear()

    def remove_tx(self, tx: Tx) -> None:
        """Tx was accepted in a block: drop everywhere; discard conflicts."""
        with self.mu:
            tx_id = tx.id()
            self.issued.pop(tx_id, None)
            self._remove(tx_id)
            for utxo in tx.input_utxos():
                other = self.utxo_spenders.pop(utxo, None)
                if other is not None and other != tx_id:
                    conflicting = self.txs.get(other)
                    self._remove(other)  # clears ALL of its utxo entries
                    if conflicting is not None:
                        self._discard(other, conflicting)

    def _discard(self, tx_id: bytes, tx: Tx) -> None:  # guarded-by: mu
        self.discarded[tx_id] = tx
        while len(self.discarded) > DISCARDED_CACHE_SIZE:
            self.discarded.popitem(last=False)

    def get(self, tx_id: bytes) -> Optional[Tx]:
        with self.mu:
            return self.txs.get(tx_id) or self.issued.get(tx_id) or self.discarded.get(tx_id)

    def has(self, tx_id: bytes) -> bool:
        return self.get(tx_id) is not None

    def __len__(self) -> int:
        with self.mu:
            return len(self.txs)
