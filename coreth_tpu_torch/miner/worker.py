"""On-demand block assembly (semantics of coreth miner/worker.go);
counterpart of coreth_tpu/miner/worker.py.

No PoW and no async mining loops: the VM's buildBlock calls
commit_new_work once per block (worker.go:118-195) — prepare the header,
derive the dynamic base fee, pull pending txs in price-and-nonce order,
apply them, and FinalizeAndAssemble through the engine (which pulls
atomic txs via the VM callback). finalize_and_assemble's
StateDB.intermediate_root is the block's device commit: the storage tries
in one planned program on K1 (under the degradation ladder) and, on a
resident chain, the account trie previewed on the mirror's executor (K1).
"""

from __future__ import annotations

import heapq
import time as _time
from typing import Dict, List, Optional

from .. import params
from ..consensus.dummy import calc_base_fee
from ..core.state_processor import apply_transaction, new_block_context
from ..core.state_transition import GasPool
from ..core.types import Block, Header, Transaction

BLACKHOLE_ADDR = b"\x01" + b"\x00" * 19


class TxByPriceAndNonce:
    """transactionsByPriceAndNonce: per-account nonce order, price heap
    across accounts (miner/ordering.go)."""

    def __init__(self, pending: Dict[bytes, List[Transaction]], base_fee: Optional[int]):
        self.base_fee = base_fee
        self.heads: list = []
        self.txs = {a: list(txs) for a, txs in pending.items()}
        for i, (addr, txs) in enumerate(sorted(self.txs.items())):
            if txs:
                tx = txs[0]
                heapq.heappush(
                    self.heads, (-tx.effective_gas_tip(base_fee), i, addr)
                )

    def peek(self) -> Optional[Transaction]:
        while self.heads:
            _, _, addr = self.heads[0]
            if self.txs.get(addr):
                return self.txs[addr][0]
            heapq.heappop(self.heads)
        return None

    def shift(self) -> None:
        """Advance to the sender's next tx."""
        if not self.heads:
            return
        neg_tip, i, addr = heapq.heappop(self.heads)
        txs = self.txs.get(addr)
        if txs:
            txs.pop(0)
            if txs:
                heapq.heappush(
                    self.heads,
                    (-txs[0].effective_gas_tip(self.base_fee), i, addr),
                )

    def pop(self) -> None:
        """Drop the sender entirely (tx failed)."""
        if self.heads:
            _, _, addr = heapq.heappop(self.heads)
            self.txs.pop(addr, None)


class Worker:
    def __init__(self, config, engine, chain, tx_pool=None, clock=None):
        self.config = config
        self.engine = engine
        self.chain = chain
        self.tx_pool = tx_pool
        self.clock = clock or (lambda: int(_time.time()))
        self.coinbase = BLACKHOLE_ADDR

    def commit_new_work(self, pending: Optional[Dict[bytes, List[Transaction]]] = None) -> Block:
        """commitNewWork (worker.go:118-195) → assembled block."""
        from ..metrics.spans import span

        with span("miner/build"):
            return self._commit_new_work(pending)

    def _commit_new_work(self, pending: Optional[Dict[bytes, List[Transaction]]] = None) -> Block:
        parent = self.chain.current_block
        timestamp = max(self.clock(), parent.time)

        gas_limit = self._gas_limit(parent.header, timestamp)
        header = Header(
            parent_hash=parent.hash(),
            coinbase=self.coinbase,
            number=parent.number + 1,
            gas_limit=gas_limit,
            time=timestamp,
            difficulty=1,
        )
        if self.config.is_apricot_phase3(timestamp):
            window, base_fee = calc_base_fee(self.config, parent.header, timestamp)
            header.extra = window
            header.base_fee = base_fee

        statedb = self.chain.state_at(parent.root)

        # CheckConfigurePrecompiles (miner/worker.go:170): the block being
        # built must see precompiles activated by its own timestamp
        self.config.check_configure_precompiles(parent.header.time, header, statedb)

        if pending is None:
            pending = self.tx_pool.pending_txs() if self.tx_pool is not None else {}

        txs: List[Transaction] = []
        receipts: list = []
        used_gas = [0]
        gp = GasPool(header.gas_limit)

        from ..evm.evm import EVM, Config, TxContext

        block_ctx = new_block_context(header, self.chain, self.coinbase)
        evm = EVM(block_ctx, TxContext(), statedb, self.config, Config())

        ordered = TxByPriceAndNonce(pending, header.base_fee)
        while True:
            tx = ordered.peek()
            if tx is None:
                break
            if gp.gas < params.TX_GAS:
                break
            statedb.set_tx_context(tx.hash(), len(txs))
            snap = statedb.snapshot()
            try:
                receipt = apply_transaction(
                    self.config, self.chain, evm, gp, statedb, header, tx, used_gas
                )
            except Exception:
                # unminable tx: reverted and skipped — the reference logs
                # every commitTransaction failure; we count them
                from ..metrics import count_drop

                count_drop("miner/tx_apply_error")
                statedb.revert_to_snapshot(snap)
                ordered.pop()
                continue
            txs.append(tx)
            receipts.append(receipt)
            ordered.shift()

        header.gas_used = used_gas[0]
        block = self.engine.finalize_and_assemble(
            self.config, header, parent.header, statedb, txs, receipts
        )
        # persist the assembled block's state so verify can run against it
        root = statedb.commit(self.config.is_eip158(block.number))
        assert root == block.header.root
        return block

    def _gas_limit(self, parent: Header, timestamp: int) -> int:
        if self.config.is_cortina(timestamp):
            return params.CORTINA_GAS_LIMIT
        if self.config.is_apricot_phase1(timestamp):
            return params.APRICOT_PHASE1_GAS_LIMIT
        return parent.gas_limit
