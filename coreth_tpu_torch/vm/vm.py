"""The snowman ChainVM (semantics of coreth plugin/evm/vm.go); counterpart
of coreth_tpu/vm/vm.py.

Initialize wires config → databases → genesis/fork config → chain backend
→ mempools → atomic state (vm.go:315-549); buildBlock assembles through
the miner + atomic mempool (:991-1032); parseBlock/getBlock/SetPreference
serve the consensus engine (:1034-1096). Atomic txs flow through the
ConsensusCallbacks into block bodies (vm.go:696-851).

The device: `initialize(..., device=None)` takes the port's explicit
device (None is CUDA, "cpu" only when asked) and hands it to
get_batch_keccak (the state's and the atomic trie's device seam) and to
BlockChain (its "auto" probe and the resident mirror). So a block built
here hashes its storage tries in one planned program on K1 under the
degradation ladder, and on CUDA its account trie on the mirror's executor
on K1; the chain's four device_* knobs configure the ladder.

The RPC surface is vm/api.py:create_handlers(vm), which sets
`vm.rpc_server` and `vm.eth_backend`, and vm/api.py:serve_ws(vm, ...)
for WebSocket; shutdown() drains and stops that server. The continuous
and sampling profilers, the metrics endpoint and the lock telemetry start
from their knobs at initialize. The node keystore (keystore-directory)
and the external signer (keystore-external-signer) back the wallet
methods; shutdown() closes the keystore, cancelling its relock timers
(ROADMAP Queue 3).

The inbound sync server is `vm.sync_handler` (sync/handlers.SyncHandler:
leaf, block and code requests served off this chain, with the snapshot
fast path when the chain runs one); a state-syncing node wraps its VM in
vm/syncervm.StateSyncClient, which debug_syncStatus then finds as
`vm.state_sync_client`.

The cross-chain eth_call both ways: handle_cross_chain_request serves an
EthCallRequest against this chain's latest accepted state (register it
with Network.register_cross_chain_handler(vm.chain_id_bytes, ...)), and
cross_chain_eth_call asks another chain's VM; execution errors travel
in-band in the EthCallResponse.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import params
from ..consensus.dummy import ConsensusCallbacks, DummyEngine
from ..core.blockchain import BlockChain, CacheConfig
from ..core.genesis import Genesis
from ..core.txpool import TxPool, TxPoolConfig
from ..core.types import Block as EthBlock
from ..device import DeviceLike
from ..metrics import phase_timer
from ..miner.worker import Worker
from ..state.database import Database
from ..trie.triedb import TrieDatabase
from .atomic_tx import Tx, encode_atomic_txs, extract_atomic_txs
from .block import BlockStatus, VMBlock
from .mempool import Mempool

AVAX_ASSET_ID = b"\x41" * 32  # test default; ctx overrides

@dataclass
class VMConfig:
    """plugin/evm/config.go subset — the knobs the runtime honors now."""

    pruning: bool = True
    commit_interval: int = 4096
    mempool_size: int = 4096
    clock: Optional[object] = None
    # flat snapshot tree (config.go snapshot-cache; 0 disables)
    snapshot_limit: int = 256
    # the device seam (ops/device.get_batch_keccak): "auto"/"planned" one
    # planned program a commit (K1), "batched" level by level (K2), "off"
    # the CPU hasher
    device_hasher: str = "auto"
    # device-resident account trie (CacheConfig.resident_account_trie):
    # per-block account hashing as one resident commit on the mirror.
    # "auto": on exactly when the VM's device is CUDA
    resident_account_trie: "bool | str" = "auto"
    # watchdog (s) per resident device commit; on expiry the commit raises
    # DeviceWedgedError to the caller (the port never takes over by itself)
    resident_commit_timeout: "float | None" = 180.0
    # resident mirror host preference (True: host commits; "auto" and
    # False keep the device path)
    resident_prefer_host: "bool | str" = "auto"
    # native CPU hasher worker threads; 0 = auto
    cpu_threads: int = 0


@dataclass
class SnowContext:
    """snow.Context subset the VM needs (ids + shared memory)."""

    network_id: int = 1337
    chain_id: bytes = b"\x02" * 32          # this blockchain's avalanche ID
    x_chain_id: bytes = b"\x58" * 32
    avax_asset_id: bytes = AVAX_ASSET_ID
    shared_memory: object = None


class VMError(Exception):
    pass


class VM:
    def __init__(self):
        self.initialized = False

    # --- snowman ChainVM: Initialize (vm.go:315-549) ----------------------

    def initialize(
        self,
        ctx: SnowContext,
        diskdb,
        genesis: Genesis,
        config: VMConfig = None,
        to_engine=None,
        config_bytes: bytes = b"",
        device: DeviceLike = None,
    ) -> None:
        """`device` is the VM's device (None is CUDA, "cpu" only when
        asked): the device seam of its state and atomic trie and the
        chain's device."""
        self.ctx = ctx
        self.device = device
        if config is None and config_bytes:
            # JSON blob from the node (vm.go:326-334) → runtime knobs
            from .config import parse_config

            full = parse_config(config_bytes)
            self.full_config = full
            config = VMConfig(
                pruning=full.pruning_enabled,
                commit_interval=full.commit_interval,
                mempool_size=full.tx_pool_global_slots,
                device_hasher=full.device_hasher,
                resident_account_trie=full.resident_account_trie,
                # pass 0 through untouched: the mirror reads it as
                # "explicitly disabled" — collapsing it to None would
                # re-open the env-var override the operator turned off
                resident_commit_timeout=full.resident_commit_timeout,
                resident_prefer_host=full.resident_prefer_host,
                cpu_threads=full.cpu_threads,
            )
        else:
            from .config import Config as FullConfig

            self.full_config = FullConfig()
        self.config = config or VMConfig()
        self.chain_config = genesis.config
        self.network_id = ctx.network_id
        self.chain_id_bytes = ctx.chain_id
        self.avax_asset_id = ctx.avax_asset_id
        self.shared_memory = (
            ctx.shared_memory.new_shared_memory(ctx.chain_id)
            if hasattr(ctx.shared_memory, "new_shared_memory")
            else ctx.shared_memory
        )
        self.atomic_codec = None
        self.to_engine = to_engine  # callable: notify engine txs are ready

        # honor global observability knobs (vm.go:344-353 log config;
        # metrics.EnabledExpensive gate) — ONLY when the blob set them:
        # these are process-global, and a second VM in the same process
        # must not silently reset the first one's diagnostics
        explicit = getattr(self.full_config, "explicit_keys", set())
        if "log_level" in explicit:
            from .. import log as _log

            _log.set_level(self.full_config.log_level)
        if "metrics_expensive_enabled" in explicit:
            from .. import metrics as _metrics

            _metrics.enabled_expensive = (
                self.full_config.metrics_expensive_enabled)
        if "evm_fastloop" in explicit:
            from ..evm import interpreter as _interp

            _interp.FASTLOOP_DEFAULT = bool(self.full_config.evm_fastloop)
        if "spans_enabled" in explicit:
            from ..metrics import spans as _spans

            _spans.set_enabled(self.full_config.spans_enabled)
        if "span_ring_size" in explicit:
            from ..metrics import spans as _spans

            _spans.tracer.set_capacity(self.full_config.span_ring_size)
        if "tracing_enabled" in explicit:
            from ..metrics import tracectx as _tracectx

            _tracectx.set_enabled(self.full_config.tracing_enabled)
        if "lock_slow_hold_budget" in explicit:
            from ..utils import racecheck as _racecheck

            _racecheck.set_slow_hold_budget(
                self.full_config.lock_slow_hold_budget)
        if "trace_ring_size" in explicit:
            from ..metrics import tracectx as _tracectx

            _tracectx.ring.set_capacity(self.full_config.trace_ring_size)
        if "shard_telemetry_enabled" in explicit:
            from ..core import exec_shards as _exec_shards

            _exec_shards.set_telemetry_enabled(
                self.full_config.shard_telemetry_enabled)

        # node keystore (node/ keystore dir role; backs avax.importKey/
        # exportKey/import/export and the eth/personal signing RPC)
        ks_dir = self.full_config.keystore_directory
        if ks_dir:
            from ..accounts.keystore import KeyStore

            self.keystore = KeyStore(ks_dir)
        else:
            self.keystore = None
        # external (clef-style) signer daemon (accounts/external/
        # backend.go role): its accounts merge into eth_accounts, and
        # eth_signTransaction/sendTransaction for them route over IPC
        self.external_signer = None
        ext_path = self.full_config.keystore_external_signer
        if ext_path:
            from ..accounts.external import ExternalSigner

            self.external_signer = ExternalSigner(ext_path)

        clock = self.config.clock or (lambda: self._now())

        cb = ConsensusCallbacks(
            on_finalize_and_assemble=self._on_finalize_and_assemble,
            on_extra_state_change=self._on_extra_state_change,
        )
        self.engine = DummyEngine(cb)

        from ..ops.device import get_batch_keccak

        self.state_database = Database(TrieDatabase(
            diskdb,
            batch_keccak=get_batch_keccak(self.config.device_hasher, device),
        ))
        full = self.full_config
        self.blockchain = BlockChain(
            diskdb,
            CacheConfig(
                pruning=self.config.pruning,
                commit_interval=self.config.commit_interval,
                device_hasher=self.config.device_hasher,
                resident_account_trie=self.config.resident_account_trie,
                resident_commit_timeout=self.config.resident_commit_timeout,
                resident_prefer_host=self.config.resident_prefer_host,
                cpu_threads=self.config.cpu_threads,
                snapshot_limit=self.config.snapshot_limit,
                trie_dirty_limit=full.trie_dirty_cache * 1024 * 1024,
                flight_recorder_size=full.flight_recorder_size,
                device_call_timeout=full.device_call_timeout,
                device_max_retries=full.device_max_retries,
                device_probe_interval=full.device_probe_interval,
                device_promote_after=full.device_promote_after,
                resident_spot_check_interval=(
                    full.resident_spot_check_interval),
                resident_pipeline_depth=full.resident_pipeline_depth,
                insert_pipeline_depth=full.insert_pipeline_depth,
                resident_template_residency=(
                    full.resident_template_residency),
                resident_mesh_devices=full.resident_mesh_devices,
                tail_join_timeout=full.tail_join_timeout,
                db_verify_on_read=full.db_verify_on_read,
                db_retry_budget=full.db_retry_budget,
                state_backend=full.state_backend,
                shadow_check_interval=full.shadow_check_interval,
                evm_parallel_workers=full.evm_parallel_workers,
                evm_exec_shards=full.evm_exec_shards,
                insert_slo_budget=full.chain_insert_slo_budget,
            ),
            self.chain_config,
            genesis,
            self.engine,
            state_database=self.state_database,
            device=device,
        )
        self.txpool = TxPool(
            TxPoolConfig(
                price_limit=full.tx_pool_price_limit,
                price_bump=full.tx_pool_price_bump,
                account_slots=full.tx_pool_account_slots,
                global_slots=full.tx_pool_global_slots,
                account_queue=full.tx_pool_account_queue,
                global_queue=full.tx_pool_global_queue,
            ),
            self.chain_config, self.blockchain,
        )
        self.miner = Worker(
            self.chain_config, self.engine, self.blockchain,
            tx_pool=self.txpool, clock=clock,
        )

        # fork-scheduled gas-price floors (vm.go handleGasPriceUpdates).
        # Wall clock on purpose: fork timestamps are wall times and the
        # coreth schedules with time.Until — the VM's block-timestamp
        # clock override must not skew the schedule.
        from .plumbing import GasPriceUpdater

        self.gas_price_updater = GasPriceUpdater(
            self.txpool, self.chain_config)
        self.gas_price_updater.start()

        def price(tx: Tx) -> int:
            gas = max(tx.gas_used(self.current_rules().is_apricot_phase5), 1)
            return tx.burned(self.avax_asset_id) // gas

        def fits_atomic_gas(tx: Tx) -> bool:
            rules = self.current_rules()
            if not rules.is_apricot_phase5:
                return True
            return tx.gas_used(True) <= params.ATOMIC_GAS_LIMIT

        self.mempool = Mempool(
            self.config.mempool_size, fee_fn=price, max_tx_gas=fits_atomic_gas
        )

        # atomic ops index with interval commits (atomic_trie.go)
        from .atomic_trie import AtomicTrie

        self.atomic_trie = AtomicTrie(
            diskdb, self.config.commit_interval,
            batch_keccak=get_batch_keccak(self.config.device_hasher, device),
        )

        self._verified_blocks: Dict[bytes, VMBlock] = {}
        self._accepted_atomic_ops: List = []

        # per-verified-block pending atomic state + tx repository
        # (atomic_backend.go / atomic_tx_repository.go)
        from .atomic_backend import AtomicBackend

        self.atomic_backend = AtomicBackend(self)
        genesis_vmb = VMBlock(self, self.blockchain.genesis_block)
        genesis_vmb.status = BlockStatus.ACCEPTED
        self.last_accepted_vm_block = genesis_vmb
        self.preferred_block: VMBlock = genesis_vmb
        self._building_txs: List[Tx] = []
        self.lock = threading.RLock()
        self.initialized = True

        # notify the engine when txs arrive (block_builder.go signal)
        # build throttling (block_builder.go:55-129): one PendingTxs
        # notification per outstanding build, retry-timer recovery
        from .block_builder import BlockBuilder

        self.block_builder = BlockBuilder(self)
        self.txpool.subscribe_new_txs(lambda txs: self._signal_txs_ready())

        # archival trie-gap healing behind the config knob (vm.go startup
        # order; core/blockchain.go:1899 populateMissingTries)
        if self.full_config.populate_missing_tries is not None:
            self.blockchain.populate_missing_tries(
                self.full_config.populate_missing_tries,
                self.full_config.populate_missing_tries_parallelism,
            )

        # inbound sync server (vm.go:547 initializeStateSyncServer): leaf/
        # block/code requests served off this chain, snapshot fast path
        # engaged automatically when the chain runs one
        from ..sync.handlers import SyncHandler

        self.sync_handler = SyncHandler(
            self.blockchain, self.state_database.triedb, diskdb
        )

        # continuous profiler (vm.go:1642, config.go:89-91)
        self.continuous_profiler = None
        if self.full_config.continuous_profiler_dir:
            from .api import ContinuousProfiler

            self.continuous_profiler = ContinuousProfiler(
                self.full_config.continuous_profiler_dir,
                freq=self.full_config.continuous_profiler_frequency,
                max_files=self.full_config.continuous_profiler_max_files,
            ).start()

        # in-process sampling profiler (metrics/profiler.py): daemon
        # thread, refcounted process-global singleton — a second VM takes
        # a reference on the same sampler and our shutdown only drops ours
        self.sampling_profiler = None
        if self.full_config.profiler_hz > 0:
            from ..metrics import profiler as _profiler

            self.sampling_profiler = _profiler.start_profiler(
                self.full_config.profiler_hz,
                ring_size=self.full_config.profiler_ring_size)

        # stdlib /metrics + /healthz endpoint (metrics/http.py), reusing
        # the health_check verdict the RPC health namespace serves
        self.metrics_http = None
        if self.full_config.metrics_http_enabled:
            from ..metrics.http import MetricsHTTPServer
            from .api import health_check

            self.metrics_http = MetricsHTTPServer(
                health_fn=lambda: health_check(self))
            self.metrics_http.start(
                host=self.full_config.metrics_http_host,
                port=self.full_config.metrics_http_port,
            )

    @staticmethod
    def _now() -> int:
        import time

        return int(time.time())

    def current_rules(self):
        head = self.blockchain.current_block
        return self.chain_config.rules(head.number + 1, head.time)

    def _signal_txs_ready(self) -> None:
        self.block_builder.signal_txs_ready()

    # --- consensus callbacks (vm.go:696-851) ------------------------------

    def _on_finalize_and_assemble(self, header, state, txs):  # guarded-by: lock
        """Pull atomic txs from the mempool into the block being built."""
        rules = self.chain_config.rules(header.number, header.time)
        batch = rules.is_apricot_phase5
        picked: List[Tx] = []
        contribution = 0
        ext_gas_used = 0
        while True:
            tx = self.mempool.next_tx()
            if tx is None:
                break
            inner_snap = state.snapshot()
            try:
                tx.semantic_verify(self, header.base_fee)
                tx.evm_state_transfer(self, state)
            except Exception:
                from ..metrics import count_drop

                count_drop("vm/build/atomic_tx_invalid")
                state.revert_to_snapshot(inner_snap)
                self.mempool.remove_tx(tx)
                continue
            if rules.is_apricot_phase4:
                try:
                    contrib, gas = tx.block_fee_contribution(
                        rules.is_apricot_phase5, self.avax_asset_id, header.base_fee
                    )
                    contribution += contrib
                    ext_gas_used += gas
                except Exception:
                    from ..metrics import count_drop

                    count_drop("vm/build/atomic_tx_fee_error")
                    state.revert_to_snapshot(inner_snap)
                    self.mempool.remove_tx(tx)
                    continue
            if batch and ext_gas_used > params.ATOMIC_GAS_LIMIT:
                # this tx overflows the AP5 atomic gas budget: undo its
                # state changes, requeue it, and build with what we have
                state.revert_to_snapshot(inner_snap)
                if rules.is_apricot_phase4:
                    # undo the contribution accounting added above
                    contrib, gas = tx.block_fee_contribution(
                        rules.is_apricot_phase5, self.avax_asset_id, header.base_fee
                    )
                    contribution -= contrib
                    ext_gas_used -= gas
                self.mempool.cancel_current_tx(tx.id())
                break
            picked.append(tx)
            if not batch:
                break
        self._building_txs = picked
        ext_data = encode_atomic_txs(picked, batch)
        return ext_data, contribution, ext_gas_used

    def _on_extra_state_change(self, block, state):
        """Verify-side: apply the block's atomic txs to the state."""
        rules = self.chain_config.rules(block.number, block.time)
        txs = extract_atomic_txs(
            block.ext_data, rules.is_apricot_phase5, self.atomic_codec
        )
        contribution = 0
        ext_gas_used = 0
        for tx in txs:
            tx.evm_state_transfer(self, state)
            if rules.is_apricot_phase4:
                contrib, gas = tx.block_fee_contribution(
                    rules.is_apricot_phase5, self.avax_asset_id, block.base_fee
                )
                contribution += contrib
                ext_gas_used += gas
        return contribution, ext_gas_used

    # --- snowman interface -------------------------------------------------

    def build_block(self) -> VMBlock:
        """buildBlock (vm.go:991-1032), under the phase vm/phase/build."""
        with phase_timer("vm/phase/build"):
            try:
                from ..metrics.spans import span

                with span("vm/buildBlock"):
                    return self._build_block_inner()
            finally:
                # the engine consumed the PendingTxs notification by
                # calling us — success or not, reopen the gate + arm the
                # retry timer (block_builder.go handleGenerateBlock)
                self.block_builder.handle_generate_block()

    def _build_block_inner(self) -> VMBlock:
        with self.lock:
            self._building_txs = []
            try:
                eth_block = self.miner.commit_new_work()
                if not eth_block.transactions and not self._building_txs:
                    raise VMError("block contains no transactions")
                vmb = VMBlock(self, eth_block)
                # verify without writes: re-executes like a peer would
                vmb.syntactic_verify()
                self.blockchain.insert_block_manual(eth_block, writes=False)
            except Exception:
                # requeue any atomic txs popped into 'issued' during the
                # failed build (vm.go buildBlock error path CancelCurrentTxs)
                for tx in list(self.mempool.issued.values()):
                    self.mempool.cancel_current_tx(tx.id())
                raise
            self.mempool.issue_current_txs()
            return vmb

    def parse_block(self, blob: bytes) -> VMBlock:
        eth_block = EthBlock.decode(blob)
        existing = self._verified_blocks.get(eth_block.hash())
        if existing is not None:
            return existing
        return VMBlock(self, eth_block)

    def get_block(self, block_id: bytes) -> Optional[VMBlock]:
        vmb = self._verified_blocks.get(block_id)
        if vmb is not None:
            return vmb
        eth_block = self.blockchain.get_block(block_id)
        if eth_block is None:
            return None
        vmb = VMBlock(self, eth_block)
        if self.blockchain.get_canonical_hash(eth_block.number) == block_id and (
            eth_block.number <= self.last_accepted_vm_block.height()
        ):
            vmb.status = BlockStatus.ACCEPTED
        return vmb

    def set_preference(self, block_id: bytes) -> None:
        """SetPreference (vm.go:1076)."""
        vmb = self.get_block(block_id)
        if vmb is None:
            raise VMError("cannot set preference to unknown block")
        self.preferred_block = vmb
        self.blockchain.set_preference(vmb.eth_block)

    def last_accepted(self) -> VMBlock:
        return self.last_accepted_vm_block

    def shutdown(self) -> None:
        """Stop the threads the VM started (the build-retry timer, the
        gas-price timers, the profilers, the metrics endpoint, the
        keystore's relock timers), drain and stop the RPC server
        create_handlers attached, then the chain (its pipeline, shard
        pool, acceptor, insert tail, ladder listener and final export).
        A WebSocket server from serve_ws is its caller's to stop first."""
        if self.initialized:
            self.block_builder.shutdown()
            self.gas_price_updater.stop()
            if self.continuous_profiler is not None:
                self.continuous_profiler.stop()
            if self.sampling_profiler is not None:
                from ..metrics import profiler as _profiler

                # drops only this VM's reference — other holders of the
                # process sampler keep sampling
                _profiler.stop_profiler()
                self.sampling_profiler = None
            if self.metrics_http is not None:
                self.metrics_http.stop()
            if self.keystore is not None:
                self.keystore.close()
            # graceful RPC drain first: in-flight reads finish (bounded
            # by rpc-drain-timeout) before the chain under them stops
            rpc_server = getattr(self, "rpc_server", None)
            if rpc_server is not None:
                rpc_server.stop()
                self.rpc_server = None
            self.blockchain.stop()

    # --- VMBlock support ---------------------------------------------------

    def add_verified_block(self, vmb: VMBlock) -> None:
        self._verified_blocks[vmb.id()] = vmb

    def forget_verified_block(self, block_id: bytes) -> None:
        self._verified_blocks.pop(block_id, None)

    def set_last_accepted(self, vmb: VMBlock) -> None:
        self.last_accepted_vm_block = vmb

    # --- atomic tx issuance (vm.go:1297-1417) -----------------------------

    # --- cross-chain eth_call capability (peer/network.go:199-301 +
    # message/eth_call_request.go): another chain's VM evaluates a
    # read-only call against OUR latest accepted state ------------------

    def handle_cross_chain_request(self, blob: bytes) -> bytes:
        """Typed cross-chain dispatcher: register with
        Network.register_cross_chain_handler(vm.chain_id_bytes, ...)."""
        import json as _json

        from ..sync.messages import (EthCallRequest, EthCallResponse,
                                     decode_message)

        msg = decode_message(blob)
        if not isinstance(msg, EthCallRequest):
            raise VMError(f"unsupported cross-chain request {type(msg)}")
        backend = getattr(self, "eth_backend", None)
        if backend is None:
            from ..eth.backend import EthBackend

            backend = EthBackend(self.blockchain, self.txpool)
            self.eth_backend = backend
        try:
            call_obj = _json.loads(msg.request_args.decode())
            result, _, _ = backend.do_call(call_obj, "latest")
        except Exception as e:  # noqa: BLE001 — errors travel in-band
            return EthCallResponse(result=b"", error=str(e).encode()).encode()
        if result.err is not None:
            return EthCallResponse(result=result.return_data,
                                   error=str(result.err).encode()).encode()
        return EthCallResponse(result=result.return_data).encode()

    def cross_chain_eth_call(self, network, chain_id: bytes,
                             call_obj: dict, deadline: float = 10.0):
        """Client side: eth_call on [chain_id]'s VM over the cross-chain
        transport. Returns the raw return data; raises VMError with the
        remote error string on failure."""
        import json as _json

        from ..sync.messages import EthCallRequest, decode_message

        req = EthCallRequest(
            request_args=_json.dumps(call_obj).encode()).encode()
        resp = decode_message(
            network.send_cross_chain_request(chain_id, req, deadline))
        if resp.error:
            raise VMError(
                f"cross-chain eth_call failed: {resp.error.decode()}")
        return resp.result

    def issue_atomic_tx(self, tx: Tx) -> None:
        tx.semantic_verify(self, self._next_base_fee())
        self.mempool.add(tx)
        self._signal_txs_ready()

    def _next_base_fee(self) -> Optional[int]:
        head = self.blockchain.current_block.header
        if not self.chain_config.is_apricot_phase3(head.time):
            return None
        from ..consensus.dummy import estimate_next_base_fee

        _, fee = estimate_next_base_fee(self.chain_config, head, head.time)
        return fee

    def issue_tx(self, tx) -> None:
        """eth tx entry (API/gossip), under the phase vm/phase/issue."""
        with phase_timer("vm/phase/issue"):
            self.txpool.add_local(tx)
