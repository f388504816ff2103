"""Block execution loop (semantics of coreth core/state_processor.go).

Process: configure per-block precompiles, apply each tx with per-tx
Finalise/IntermediateRoot (statedb journal boundaries), then the engine's
Finalize for atomic-tx extra state (state_processor.go:68-107).

The serial loop only. The reference's two speculative execution modes,
the thread-parallel `parallel_exec` and the process shards of
`exec_shards`, are ROADMAP "Still to port", item 3b.3: asking for either
(`parallel_workers`, `exec_shards_n`, CORETH_TPU_EVM_PARALLEL or
CORETH_TPU_EVM_EXEC_SHARDS) raises NotImplementedError, and nothing runs
serially in its place.

Counterpart of coreth_tpu/core/state_processor.py.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ..evm.evm import EVM, BlockContext, Config, TxContext
from ..metrics.spans import span
from .state_transition import GasPool, Message, apply_message, tx_as_message
from .types import Block, Header, Receipt, Signer

BLACKHOLE_COINBASE = b"\x01" + b"\x00" * 19


class ProcessorError(Exception):
    pass


def new_block_context(header: Header, chain, coinbase: Optional[bytes] = None) -> BlockContext:
    """NewEVMBlockContext (core/evm.go): GetHash walks the ancestry."""

    def get_hash(n: int) -> Optional[bytes]:
        if chain is None:
            return None
        return chain.get_canonical_hash(n)

    return BlockContext(
        coinbase=coinbase if coinbase is not None else header.coinbase,
        block_number=header.number,
        time=header.time,
        difficulty=max(header.difficulty, 0) or 1,
        gas_limit=header.gas_limit,
        base_fee=header.base_fee,
        get_hash=get_hash,
    )


def apply_transaction(config, chain, evm: EVM, gp: GasPool, statedb, header: Header,
                      tx, used_gas: List[int], block_hash: bytes = b"\x00" * 32) -> Receipt:
    """applyTransaction (state_processor.go:109-166)."""
    msg = tx_as_message(tx, Signer(config.chain_id), header.base_fee)
    return apply_message_to_receipt(
        config, evm, gp, statedb, header, tx, msg, used_gas, block_hash
    )


def apply_message_to_receipt(config, evm: EVM, gp: GasPool, statedb, header: Header,
                             tx, msg: Message, used_gas: List[int],
                             block_hash: bytes = b"\x00" * 32) -> Receipt:
    evm.reset(TxContext(origin=msg.from_, gas_price=msg.gas_price), statedb)
    result = apply_message(evm, msg, gp)

    # per-tx journal boundary: Finalise post-Byzantium (always on Avalanche),
    # IntermediateRoot otherwise (state_processor.go:122-126)
    if config.is_byzantium(header.number):
        statedb.finalise(True)
    else:
        statedb.intermediate_root(config.is_eip158(header.number))

    used_gas[0] += result.used_gas

    receipt = Receipt(
        type=tx.type,
        status=0 if result.failed else 1,
        cumulative_gas_used=used_gas[0],
        tx_hash=tx.hash(),
        gas_used=result.used_gas,
    )
    if msg.to is None:
        from .types import create_address

        receipt.contract_address = create_address(msg.from_, msg.nonce)
    receipt.logs = statedb.get_logs(tx.hash(), header.number, block_hash)
    from .types import logs_bloom

    receipt.bloom = logs_bloom(receipt.logs)
    receipt.block_number = header.number
    return receipt


PARALLEL_ENV = "CORETH_TPU_EVM_PARALLEL"
SHARDS_ENV = "CORETH_TPU_EVM_EXEC_SHARDS"
_NOT_PORTED = ("not ported (ROADMAP 'Still to port', item 3b.3); the "
               "port runs the serial loop only")


def _refuse_speculative(parallel_workers: int, exec_shards_n: int) -> None:
    """Raise when a speculative execution mode is asked for, through the
    knob or its env override (the reference's effective_workers /
    effective_shards read the same names; "0" asks for serial)."""
    for knob, val, env in (("evm-parallel-workers", parallel_workers,
                            PARALLEL_ENV),
                           ("evm-exec-shards", exec_shards_n, SHARDS_ENV)):
        raw = os.environ.get(env, "").strip()
        if val or raw not in ("", "0"):
            raise NotImplementedError(
                f"{knob}={val or raw} ({env}={raw!r}): {_NOT_PORTED}")


class StateProcessor:
    def __init__(self, config, chain, engine, parallel_workers: int = 0,
                 exec_shards_n: int = 0):
        _refuse_speculative(parallel_workers, exec_shards_n)
        self.config = config
        self.chain = chain
        self.engine = engine

    def process(self, block: Block, parent: Header, statedb,
                vm_config: Config = None) -> Tuple[list, list, int]:
        """Process (state_processor.go:68-107): returns (receipts, logs, gasUsed)."""
        _refuse_speculative(0, 0)
        header = block.header
        used_gas = [0]
        all_logs: list = []
        gp = GasPool(header.gas_limit)
        receipts: list = []

        # activate any stateful precompile whose fork falls in this
        # transition (state_processor.go:80)
        self.config.check_configure_precompiles(parent.time, header, statedb)

        block_ctx = new_block_context(header, self.chain)
        evm = EVM(block_ctx, TxContext(), statedb, self.config, vm_config or Config())

        with span("chain/execute/txs", number=block.number,
                  txs=len(block.transactions)):
            for i, tx in enumerate(block.transactions):
                statedb.set_tx_context(tx.hash(), i)
                try:
                    receipt = apply_transaction(
                        self.config, self.chain, evm, gp, statedb, header, tx,
                        used_gas, block.hash(),
                    )
                except Exception as e:
                    raise ProcessorError(
                        f"could not apply tx {i} [{tx.hash().hex()}]: {e}"
                    ) from e
                receipts.append(receipt)
                all_logs.extend(receipt.logs)

        # engine finalize: atomic txs mutate state via callback + fee checks
        with span("chain/execute/finalize"):
            self.engine.finalize(self.config, block, parent, statedb, receipts)

        return receipts, all_logs, used_gas[0]
