"""Genesis block construction (semantics of coreth core/genesis.go);
counterpart of coreth_tpu/core/genesis.py.

Genesis.commit() writes the allocation into a fresh StateDB, commits the
root through the TrieDatabase (the tries hash with its batch keccak: on
the card under the planned or batched marker), and persists the genesis
block through rawdb.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .. import params, rlp
from ..state.database import Database
from ..state.statedb import StateDB
from ..trie.node import EMPTY_ROOT
from . import rawdb
from .types import (
    EMPTY_RECEIPTS_HASH,
    EMPTY_TXS_HASH,
    EMPTY_UNCLE_HASH,
    Block,
    Header,
)


@dataclass
class GenesisAccount:
    balance: int = 0
    nonce: int = 0
    code: bytes = b""
    storage: Dict[bytes, bytes] = field(default_factory=dict)
    mc_balances: Dict[bytes, int] = field(default_factory=dict)


@dataclass
class Genesis:
    config: object = None
    nonce: int = 0
    timestamp: int = 0
    extra_data: bytes = b""
    gas_limit: int = params.GENESIS_GAS_LIMIT
    difficulty: int = 0
    mix_digest: bytes = b"\x00" * 32
    coinbase: bytes = b"\x00" * 20
    base_fee: Optional[int] = None
    alloc: Dict[bytes, GenesisAccount] = field(default_factory=dict)

    def to_block(self, state_db: Database) -> Block:
        """Write the alloc into state and derive the genesis header."""
        statedb = StateDB(EMPTY_ROOT, state_db)
        for addr, acct in self.alloc.items():
            statedb.add_balance(addr, acct.balance)
            statedb.set_nonce(addr, acct.nonce)
            if acct.code:
                statedb.set_code(addr, acct.code)
            for k, v in acct.storage.items():
                statedb.set_state(addr, k, v)
            for coin, amt in acct.mc_balances.items():
                statedb.add_balance_multicoin(addr, coin, amt)
        if self.config is not None:
            # genesis-activated precompiles configure the starting state
            # (genesis.go:269: parent timestamp None)
            self.config.check_configure_precompiles(
                None, Header(number=0, time=self.timestamp), statedb
            )
        root = statedb.commit(False)

        base_fee = self.base_fee
        if base_fee is None and self.config is not None and self.config.is_apricot_phase3(self.timestamp):
            base_fee = params.APRICOT_PHASE3_INITIAL_BASE_FEE

        header = Header(
            parent_hash=b"\x00" * 32,
            uncle_hash=EMPTY_UNCLE_HASH,
            coinbase=self.coinbase,
            root=root,
            tx_hash=EMPTY_TXS_HASH,
            receipt_hash=EMPTY_RECEIPTS_HASH,
            difficulty=self.difficulty,
            number=0,
            gas_limit=self.gas_limit,
            gas_used=0,
            time=self.timestamp,
            extra=self.extra_data,
            base_fee=base_fee,
        )
        return Block(header)

    def commit(self, diskdb, state_db: Database) -> Block:
        """Persist the genesis block + state root (genesis.go Commit)."""
        block = self.to_block(state_db)
        state_db.triedb.commit(block.root)
        rawdb.write_canonical_hash(diskdb, block.hash(), 0)
        rawdb.write_header_number(diskdb, block.hash(), 0)
        rawdb.write_header_rlp(diskdb, 0, block.hash(), block.header.encode())
        rawdb.write_body_rlp(diskdb, 0, block.hash(), rlp.encode([[], [], 0, b""]))
        rawdb.write_receipts_rlp(diskdb, 0, block.hash(), rlp.encode([]))
        rawdb.write_head_block_hash(diskdb, block.hash())
        rawdb.write_head_header_hash(diskdb, block.hash())
        return block


def default_test_genesis(funded: Dict[bytes, int], config=None) -> Genesis:
    cfg = config or params.TEST_CHAIN_CONFIG
    return Genesis(
        config=cfg,
        gas_limit=params.CORTINA_GAS_LIMIT if cfg.cortina_time == 0 else params.GENESIS_GAS_LIMIT,
        alloc={addr: GenesisAccount(balance=bal) for addr, bal in funded.items()},
    )
