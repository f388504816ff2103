"""Deterministic block/chain generation without consensus (semantics of
coreth core/chain_makers.go GenerateChain/BlockGen).

Used by tests and benchmarks to build valid chains: each generated block
executes its txs against the parent state, derives the dynamic fee fields
through the real engine, and commits its root through the TrieDatabase.

Counterpart of coreth_tpu/core/chain_makers.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .. import params
from ..consensus.dummy import calc_base_fee
from ..state.database import Database
from ..state.statedb import StateDB
from .state_processor import apply_transaction, new_block_context
from .state_transition import GasPool
from .types import Block, Header, Receipt, Signer, Transaction


class BlockGen:
    """Per-block mutation surface handed to the generator callback."""

    def __init__(self, i: int, parent: Block, statedb: StateDB, config, engine,
                 chain, gap: int = 10):
        self.i = i
        self.parent = parent
        self.statedb = statedb
        self.config = config
        self.engine = engine
        self.chain = chain

        self.header = _make_header(config, chain, parent, statedb, engine, gap)
        # mirror the miner's CheckConfigurePrecompiles so generated blocks
        # carry the same activation state the processor will recompute
        config.check_configure_precompiles(
            parent.header.time, self.header, statedb
        )
        self.txs: List[Transaction] = []
        self.receipts: List[Receipt] = []
        self.gas_pool = GasPool(self.header.gas_limit)
        self._used_gas = [0]

    def set_coinbase(self, addr: bytes) -> None:
        self.header.coinbase = addr

    def set_extra(self, data: bytes) -> None:
        self.header.extra = data

    def set_time(self, t: int) -> None:
        self.header.time = t

    def number(self) -> int:
        return self.header.number

    def base_fee(self) -> Optional[int]:
        return self.header.base_fee

    def add_tx(self, tx: Transaction) -> None:
        """AddTx: executes against the in-progress block state."""
        from ..evm.evm import EVM, Config, TxContext

        block_ctx = new_block_context(self.header, self.chain, self.header.coinbase)
        evm = EVM(block_ctx, TxContext(), self.statedb, self.config, Config())
        self.statedb.set_tx_context(tx.hash(), len(self.txs))
        receipt = apply_transaction(
            self.config, self.chain, evm, self.gas_pool, self.statedb,
            self.header, tx, self._used_gas,
        )
        self.txs.append(tx)
        self.receipts.append(receipt)

    def get_balance(self, addr: bytes) -> int:
        return self.statedb.get_balance(addr)

    def tx_nonce(self, addr: bytes) -> int:
        return self.statedb.get_nonce(addr)


def _make_header(config, chain, parent: Block, statedb: StateDB, engine,
                 gap: int = 10) -> Header:
    time = parent.time + gap
    header = Header(
        parent_hash=parent.hash(),
        coinbase=b"\x00" * 20,
        difficulty=1,
        number=parent.number + 1,
        gas_limit=_calc_gas_limit(config, parent.header, time),
        time=time,
    )
    if config.is_apricot_phase3(time):
        window, base_fee = calc_base_fee(config, parent.header, time)
        header.extra = window
        header.base_fee = base_fee
    return header


def _calc_gas_limit(config, parent: Header, timestamp: int) -> int:
    if config.is_cortina(timestamp):
        return params.CORTINA_GAS_LIMIT
    if config.is_apricot_phase1(timestamp):
        return params.APRICOT_PHASE1_GAS_LIMIT
    return parent.gas_limit


def generate_chain(
    config,
    parent: Block,
    engine,
    state_database: Database,
    n: int,
    gap: int = 10,
    gen: Optional[Callable[[int, BlockGen], None]] = None,
) -> Tuple[List[Block], List[List[Receipt]]]:
    """GenerateChain (chain_makers.go:167+): returns (blocks, receipts)."""
    blocks: List[Block] = []
    receipts: List[List[Receipt]] = []
    cur = parent
    for i in range(n):
        statedb = StateDB(cur.root, state_database)
        bg = BlockGen(i, cur, statedb, config, engine, None, gap=gap)
        if gen is not None:
            gen(i, bg)
        bg.header.gas_used = bg._used_gas[0]
        block = engine.finalize_and_assemble(
            config, bg.header, cur.header, statedb, bg.txs, bg.receipts
        )
        # commit returns the same root finalize_and_assemble hashed; commit
        # also persists the nodes into the TrieDatabase forest
        root = statedb.commit(config.is_eip158(block.number))
        assert root == block.header.root
        blocks.append(block)
        receipts.append(bg.receipts)
        cur = block
    return blocks, receipts
