"""Block execution loop (semantics of coreth core/state_processor.go).

Process: configure per-block precompiles, apply each tx with per-tx
Finalise/IntermediateRoot (statedb journal boundaries), then the engine's
Finalize for atomic-tx extra state (state_processor.go:68-107).

Besides the serial loop, two speculative execution modes: the process
shards of `exec_shards` (`exec_shards_n`, CORETH_TPU_EVM_EXEC_SHARDS),
checked first, and the thread-parallel Block-STM of `parallel_exec`
(`parallel_workers`, CORETH_TPU_EVM_PARALLEL). The env overrides are read
per block. A speculative failure runs the serial loop from pristine state
(the fold is the modes' only StateDB mutation and it runs last); a device
fault (device.DEVICE_FAULTS) is never a speculative failure and reaches
the caller.

Counterpart of coreth_tpu/core/state_processor.py.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..device import DEVICE_FAULTS
from ..evm.evm import EVM, BlockContext, Config, TxContext
from ..metrics import default_registry as _metrics
from ..metrics.spans import span
from . import exec_shards, parallel_exec
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


class StateProcessor:
    def __init__(self, config, chain, engine, parallel_workers: int = 0,
                 exec_shards_n: int = 0):
        self.config = config
        self.chain = chain
        self.engine = engine
        # evm-parallel-workers knob (0 = serial); CORETH_TPU_EVM_PARALLEL
        # overrides per-process at block time
        self.parallel_workers = parallel_workers
        # evm-exec-shards knob (0 = in-process paths only);
        # CORETH_TPU_EVM_EXEC_SHARDS overrides per-process at block time
        self.exec_shards = exec_shards_n
        # started on the first sharded block; guarded by _shard_mu.
        # Shared with the insert pipeline's submit stage.
        self._shard_pool = None  # guarded-by: _shard_mu
        self._shard_mu = threading.Lock()
        # stats of the most recent process() call, consumed by the
        # chain's flight recorder ("parallel" field)
        self.last_parallel: dict = {"mode": "serial"}

    def shard_pool(self):
        """The live shard pool, starting it on first use — or None when
        the knob is off, the pool is demoted (lifecycle ladder), or its
        start failed (counted as a fallback; retried next block)."""
        n = exec_shards.effective_shards(self.exec_shards)
        if n <= 0:
            return None
        with self._shard_mu:
            pool = self._shard_pool
            if pool is not None:
                return pool if pool.healthy else None
            try:
                pool = exec_shards.ShardPool(n, self.config)
            except Exception:
                _metrics.counter("exec/shard/fallbacks").inc()
                return None
            self._shard_pool = pool
            return pool

    def close(self) -> None:
        with self._shard_mu:
            pool, self._shard_pool = self._shard_pool, None
        if pool is not None:
            pool.close()

    def process(self, block: Block, parent: Header, statedb,
                vm_config: Config = None) -> Tuple[list, list, int]:
        """Process (state_processor.go:68-107): returns (receipts, logs, gasUsed)."""
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

        workers = parallel_exec.effective_workers(self.parallel_workers)
        shards = exec_shards.effective_shards(self.exec_shards)
        self.last_parallel = {"mode": "serial"}
        parallel = None
        gate_ok = (len(block.transactions) >= parallel_exec.MIN_PARALLEL_TXS
                   and (vm_config is None or vm_config.tracer is None)
                   and self.config.is_byzantium(header.number))
        if shards > 0 and gate_ok:
            # third execution mode: GIL-free process shards. Checked
            # BEFORE the thread mode; a shard fallback goes straight to
            # the serial loop (mixing both speculative paths on one
            # block would double-execute for no win).
            pool = self.shard_pool()
            if pool is not None:
                try:
                    parallel, stats = exec_shards.execute_block_sharded(
                        self.config, block, parent, statedb, block_ctx,
                        vm_config or Config(), shards, pool,
                    )
                except DEVICE_FAULTS:
                    raise
                except Exception:
                    # same contract as the thread mode: the fold is the
                    # only StateDB mutation and it runs last, so the
                    # serial loop below re-executes from pristine state
                    _metrics.counter("exec/shard/fallbacks").inc()
                    parallel, stats = None, {
                        "mode": "serial", "workers": shards,
                        "conflicts": 0, "reexecs": 0, "deps": 0,
                        "fallback": True,
                    }
                self.last_parallel = stats
        elif workers > 0 and gate_ok:
            try:
                parallel, stats = parallel_exec.execute_block(
                    self.config, block, parent, statedb, block_ctx,
                    vm_config or Config(), workers,
                )
            except DEVICE_FAULTS:
                raise
            except Exception:
                # optimistic path must never take down block processing:
                # the fold is its only StateDB mutation and it runs last,
                # so the serial loop below re-executes from pristine state
                _metrics.counter("exec/parallel/fallbacks").inc()
                parallel, stats = None, {
                    "mode": "serial", "workers": workers, "conflicts": 0,
                    "reexecs": 0, "deps": 0, "fallback": True,
                }
            self.last_parallel = stats

        if parallel is not None:
            receipts, all_logs, used_gas[0] = parallel
            with span("chain/execute/finalize"):
                self.engine.finalize(self.config, block, parent, statedb, receipts)
            return receipts, all_logs, used_gas[0]

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
