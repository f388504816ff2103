"""VM configuration (semantics of coreth plugin/evm/config.go); counterpart
of coreth_tpu/vm/config.py.

The node hands the VM a JSON blob at Initialize (vm.go:327); it decodes
into Config with SetDefaults/Validate. The knob set mirrors config.go
:80-193 — caches, pruning, tx pool, gossip, state sync, profiling, API
gating.

Every knob that no module of the port reads raises NotImplementedError
from validate(), naming its ROADMAP item, when set away from its default
(NOT_PORTED): those of config.go that neither package's VM, chain, RPC
tier or gossiper reads (state-sync-enabled and its siblings among them,
remote-gossip-only-enabled and regossip-tx-queue-size too: only this
Config names them). regossip-frequency and regossip-max-txs configure
vm/gossiper.Gossiper. The sync-* knobs configure SyncClient.from_config and its
peer ladder (sync/client.py); state-sync-commit-interval is validated
against commit-interval, as in the reference.
A VM never boots with a knob silently ignored; keys Config does not know
are ignored, as the reference ignores them. device-max-retries is
refused but at 0: the port retries no device dispatch (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import List, Optional

DEFAULT_ETH_APIS = [
    "eth", "eth-filter", "net", "web3", "internal-eth", "internal-blockchain",
    "internal-transaction",
]


@dataclass
class Config:
    # --- API gating (config.go eth-apis) ---------------------------------
    eth_apis: List[str] = field(default_factory=lambda: list(DEFAULT_ETH_APIS))
    admin_api_enabled: bool = False
    health_api_enabled: bool = True
    coreth_admin_api_enabled: bool = False
    ws_cpu_refill_rate: int = 0
    ws_cpu_max_stored: int = 0
    api_max_duration: float = 0.0
    api_max_blocks_per_request: int = 0
    allow_unfinalized_queries: bool = False
    allow_unprotected_txs: bool = False

    # --- RPC overload protection (ROBUSTNESS.md: serving under overload) --
    # cheap-lane worker threads; 0 disables pooling entirely (inline
    # dispatch on the transport thread — the seed behavior)
    rpc_max_workers: int = 8
    # cheap-lane admission queue depth; a full queue sheds -32005/429
    rpc_queue_size: int = 64
    # expensive-lane (eth_call/eth_getLogs/debug_trace*) workers + queue:
    # a tracing storm saturates this lane and never touches cheap reads
    rpc_expensive_workers: int = 4
    rpc_expensive_queue_size: int = 16
    # expensive-method deadline budget (s); 0 falls back to
    # api-max-duration (which covers cheap methods). 0/0 = no deadlines
    rpc_expensive_duration: float = 0.0
    # batch + body caps (proper error object instead of an OOM)
    rpc_batch_limit: int = 100
    rpc_body_limit: int = 5 * 1024 * 1024
    # expensive-method circuit breaker: threshold consecutive timeouts
    # open it; while open every probe-every-th arrival probes; close-after
    # consecutive probe passes re-close it. threshold 0 disables
    rpc_breaker_threshold: int = 5
    rpc_breaker_probe_every: int = 8
    rpc_breaker_close_after: int = 3
    # stop() drains in-flight dispatch up to this many seconds before
    # abandoning (reported in the drain result)
    rpc_drain_timeout: float = 5.0
    # concurrent HTTP connection cap (excess answered 429 inline); 0 off
    rpc_max_connections: int = 128
    # per-websocket-client bounded notification queue; overflow
    # disconnects the slow client. 0 = legacy unbuffered direct writes
    ws_notify_queue_size: int = 256
    # successful requests slower than this (seconds) are auto-captured
    # into the trace ring (debug_traceRequest); 0 disables auto-capture
    rpc_slo_budget: float = 1.0

    # --- caches ----------------------------------------------------------
    trie_clean_cache: int = 512        # MB
    trie_dirty_cache: int = 256        # MB
    trie_dirty_commit_target: int = 20  # MB
    snapshot_cache: int = 256          # MB
    accepted_cache_size: int = 32
    # read-tier result caches (eth/cache.py): gasprice oracle tips keyed
    # by accepted-head hash, and eth_getLogs bloom-index candidate
    # offsets keyed by (section, criteria). 0 disables a cache
    gasprice_cache_size: int = 8
    logs_cache_size: int = 64

    # --- eth settings -----------------------------------------------------
    preimages_enabled: bool = False
    snapshot_async: bool = True
    snapshot_verification_enabled: bool = False
    # fast EVM dispatch loop (pre-parsed instruction streams); false
    # reverts to the legacy dict-dispatch loop. The CORETH_TPU_EVM_FASTLOOP
    # env var overrides either way.
    evm_fastloop: bool = True
    # Block-STM optimistic parallel execution workers (core/parallel_exec):
    # transactions execute concurrently against versioned reads and fold
    # deterministically in tx-index order. 0 (default) keeps the serial
    # loop; the CORETH_TPU_EVM_PARALLEL env var overrides either way.
    evm_parallel_workers: int = 0
    # GIL-free process-level execution shards (core/exec_shards): forked
    # worker processes run speculative tx execution and ship write-sets
    # back for the deterministic fold/validate gate. 0 (default) keeps
    # the in-process paths; checked before evm-parallel-workers; the
    # CORETH_TPU_EVM_EXEC_SHARDS env var overrides either way.
    evm_exec_shards: int = 0

    # --- pruning ----------------------------------------------------------
    pruning_enabled: bool = True
    commit_interval: int = 4096
    accepted_queue_limit: int = 64
    allow_missing_tries: bool = False
    populate_missing_tries: Optional[int] = None
    populate_missing_tries_parallelism: int = 1024
    offline_pruning_enabled: bool = False
    offline_pruning_bloom_filter_size: int = 512   # MB
    offline_pruning_data_directory: str = ""

    # --- device hashing ---------------------------------------------------
    # "auto": large dirty sets drain to the device keccak; "off": CPU only
    device_hasher: str = "auto"
    # device-resident account trie: block commits run as resident device
    # commits on the account-trie mirror (trie/resident_mirror.py);
    # requires the native incremental planner (silent fallback otherwise).
    # "auto" (default): ON exactly when a TPU backend resolves — the
    # TPU-native path is the production default on TPU hardware, with a
    # host takeover if the device later fails (resident-commit-timeout)
    resident_account_trie: "bool | str" = "auto"
    # watchdog budget (s) per resident device commit; on expiry the
    # mirror takes over on the host and the chain continues (0 disables)
    resident_commit_timeout: float = 180.0
    # resident mirror host preference: "auto" (default) runs commits on
    # the threaded native CPU hasher whenever no TPU backend resolves
    # (the XLA-CPU "device" keccak is ~150x slower than native); true
    # forces host commits, false pins the device path even on CPU
    resident_prefer_host: "bool | str" = "auto"
    # cross-commit device pipelining depth (0-4; 1-2 recommended): up to
    # this many resident commits stay in flight on the device, their
    # roots optimistically recorded as the header roots and compared at
    # the next drain point (accept/reject/reorg/spot-check/export) —
    # host planning of block k+1 overlaps device execution of block k.
    # 0 = every commit synchronizes before verify returns
    resident_pipeline_depth: int = 0
    # staged insert pipeline depth (0-3): up to this many successor
    # blocks run sender recovery + speculative execution (against the
    # predecessor's speculated post-state) while the predecessor holds
    # chainmu for commit/device-hash/write. 0 = serial insert loop
    insert_pipeline_depth: int = 0
    # template residency: per-commit device->host digest absorb keeps
    # the host cache warm (root/export always valid, instant takeover)
    # while the device keeps row arenas + digest store resident, so
    # uploads carry only fresh leaf content. Excludes pipelining
    resident_template_residency: bool = False
    # mesh-sharded resident commits: split the mirror's digest store +
    # row arenas by rows over this many mesh positions (parallel.
    # make_mesh on the VM's device argument). 0 = unsharded single-device
    # executor (default); widths must divide the 16-lane planner bucket,
    # so 1/2/4/8. The caller's take_over_host() demotes mesh ->
    # single-device resident -> host, each rung bit-exact vs the host
    # oracle
    resident_mesh_devices: int = 0
    # native CPU hasher worker threads (plan execute + batch keccak);
    # 0 = auto (env CORETH_TPU_CPU_THREADS, else min(16, cores))
    cpu_threads: int = 0

    # --- robustness (ROBUSTNESS.md: device degradation ladder + tail) ----
    # per-call watchdog deadline (s) for laddered device dispatches
    # (planned commit, batched keccak); 0 disables the watchdog
    device_call_timeout: float = 0.0
    # retries of a failed laddered dispatch: the port retries none (a
    # device fault reaches the caller; ROADMAP Queue 3), so anything but
    # 0 raises (the reference's default is 1)
    device_max_retries: int = 0
    # seconds between background health probes while demoted; <= 0 means
    # demotion is permanent for the process
    device_probe_interval: float = 5.0
    # consecutive healthy probes required before re-promotion
    device_promote_after: int = 3
    # resident-mirror spot check (device root vs host keccak oracle)
    # every K committed inserts; divergence quarantines the mirror. 0 off
    resident_spot_check_interval: int = 0
    # deadline (s) for insert-tail / acceptor-queue joins; on expiry the
    # join raises a diagnosable TailStalled instead of hanging. 0 off
    tail_join_timeout: float = 0.0
    # re-hash hash-addressed payloads (headers/code, body/receipt
    # content) as they leave disk: a mismatch raises typed
    # CorruptDataError + counts db/verify_failures instead of feeding
    # bad bytes into consensus ("db-verify-on-read")
    db_verify_on_read: bool = False
    # transient storage-error retries (fault.Backoff-paced) for insert
    # tail writes before the chain demotes itself to the degraded
    # read-only rung; 0 = first failure degrades ("db-retry-budget")
    db_retry_budget: int = 2
    # commitment backend (COMMITMENT.md): "mpt" (consensus default) or
    # "bintrie-shadow" (mount the experimental binary-Merkle backend
    # beside the MPT; divergences quarantine, consensus is unaffected)
    state_backend: str = "mpt"
    # shadow canonical-rebuild spot check every K commits; 0 disables
    shadow_check_interval: int = 16

    # --- tx pool ----------------------------------------------------------
    local_txs_enabled: bool = False
    tx_pool_price_limit: int = 1
    tx_pool_price_bump: int = 10
    tx_pool_account_slots: int = 16
    tx_pool_global_slots: int = 4096
    tx_pool_account_queue: int = 64
    tx_pool_global_queue: int = 1024

    # --- gossip -----------------------------------------------------------
    remote_gossip_only_enabled: bool = False
    regossip_frequency: float = 60.0
    regossip_max_txs: int = 16
    regossip_tx_queue_size: int = 64

    # --- logging / profiling ---------------------------------------------
    log_level: str = "info"
    log_json_format: bool = False
    continuous_profiler_dir: str = ""
    continuous_profiler_frequency: float = 900.0
    continuous_profiler_max_files: int = 5

    # --- metrics / observability -----------------------------------------
    metrics_expensive_enabled: bool = False
    # block-pipeline span tracing (metrics/spans.py): process-global, so
    # like log-level it only applies when set explicitly. The
    # CORETH_TPU_SPANS env var seeds the default.
    spans_enabled: bool = False
    # finished-span ring capacity (debug_spanDump window)
    span_ring_size: int = 4096
    # per-chain flight recorder depth (debug_blockFlightRecord window)
    flight_recorder_size: int = 64
    # stdlib /metrics + /healthz endpoint (metrics/http.py); binds
    # loopback unless metrics-http-host says otherwise, port 0 = ephemeral
    metrics_http_enabled: bool = False
    metrics_http_host: str = "127.0.0.1"
    metrics_http_port: int = 0
    # request/insert trace-id propagation (metrics/tracectx.py):
    # process-global like spans-enabled, so it only applies when set
    # explicitly; the CORETH_TPU_TRACING env var seeds the default (on)
    tracing_enabled: bool = True
    # captured-trace ring capacity (debug_traceRequest window)
    trace_ring_size: int = 256
    # block-insert SLO budget (seconds): inserts slower than this are
    # auto-captured into the trace ring; 0 disables auto-capture
    chain_insert_slo_budget: float = 0.0
    # in-process sampling profiler (metrics/profiler.py): samples per
    # second the daemon thread walks sys._current_frames(); 0 = off.
    # Process-global like spans — debug_profileDump serves the table.
    profiler_hz: float = 0.0
    # max distinct (role, collapsed-stack) rows before new stacks fold
    # into a per-role overflow bucket
    profiler_ring_size: int = 2048
    # seconds a single canonical-lock hold may last before racecheck
    # captures traceback + trace id (utils/racecheck.py); 0 = off.
    # Checked by the lock proxies that fault/chaos.py's witness installs
    lock_slow_hold_budget: float = 0.0
    # gates the parent-side registry merge of shard-worker ShardStats
    # deltas (the per-worker flight-record stamp stays on regardless)
    shard_telemetry_enabled: bool = True

    # --- keystore ---------------------------------------------------------
    keystore_directory: str = ""
    keystore_external_signer: str = ""
    keystore_insecure_unlock_allowed: bool = False

    # --- state sync -------------------------------------------------------
    state_sync_enabled: bool = False
    state_sync_skip_resume: bool = False
    state_sync_server_trie_cache: int = 64  # MB
    state_sync_ids: str = ""
    state_sync_commit_interval: int = 16384
    state_sync_min_blocks: int = 300_000

    # --- sync robustness (ROBUSTNESS.md: bootstrap under Byzantine peers) -
    # peer rotation attempts per logical request
    sync_max_attempts: int = 32
    # capped-exponential backoff between attempts (seconds)
    sync_backoff_base: float = 0.02
    sync_backoff_cap: float = 1.0
    # per-request-class deadlines (seconds); each is additionally capped
    # by any ambient utils/deadline budget on the calling thread
    sync_leafs_deadline: float = 10.0
    sync_blocks_deadline: float = 10.0
    sync_code_deadline: float = 10.0
    # hedged duplicate leafs requests: after hedge-delay seconds without
    # an answer, the next-best peer races the primary (tail latency)
    sync_hedge_requests: bool = False
    sync_hedge_delay: float = 0.25
    # distinct don't-have peers before a root is presumed stale and the
    # sync pivots (clamped down to the connected-peer count)
    sync_stale_root_votes: int = 3
    # peer ladder: cumulative failure score that turns a peer suspect /
    # quarantined, the base quarantine window (doubles per strike), and
    # consecutive probe passes that re-admit a quarantined peer
    sync_suspect_score: float = 4.0
    sync_quarantine_score: float = 8.0
    sync_quarantine_seconds: float = 30.0
    sync_readmit_probes: int = 2

    # --- misc -------------------------------------------------------------
    max_outbound_active_requests: int = 16
    max_outbound_active_cross_chain_requests: int = 64

    # which field names the Initialize JSON blob set explicitly (filled by
    # parse_config) — process-global settings (log level, expensive
    # metrics) are only applied when the operator actually asked
    explicit_keys: set = field(default_factory=set)

    def validate(self) -> None:
        """config.go Validate, then the port's refusal of the knobs of
        parts it does not have (NOT_PORTED)."""
        if self.populate_missing_tries is not None and (
            self.offline_pruning_enabled or self.pruning_enabled
        ):
            raise ValueError(
                "cannot enable populate-missing-tries while pruning (must be archival)"
            )
        if self.offline_pruning_enabled and not self.pruning_enabled:
            raise ValueError("cannot run offline pruning while pruning is disabled")
        if self.commit_interval == 0 and self.pruning_enabled:
            raise ValueError("commit interval must be non-zero in pruning mode")
        if self.state_sync_commit_interval % self.commit_interval != 0:
            raise ValueError(
                f"state sync commit interval ({self.state_sync_commit_interval}) "
                f"must be a multiple of commit interval ({self.commit_interval})"
            )
        if self.device_hasher not in ("auto", "planned", "batched", "fused", "off"):
            raise ValueError(f"unknown device-hasher mode {self.device_hasher!r}")
        if self.resident_account_trie not in (True, False, "auto"):
            raise ValueError(
                f"resident-account-trie must be true, false, or \"auto\" "
                f"(got {self.resident_account_trie!r})")
        if self.resident_prefer_host not in (True, False, "auto"):
            raise ValueError(
                f"resident-prefer-host must be true, false, or \"auto\" "
                f"(got {self.resident_prefer_host!r})")
        if self.cpu_threads < 0:
            raise ValueError(
                f"cpu-threads must be >= 0 (got {self.cpu_threads})")
        if not (0 <= self.resident_pipeline_depth <= 4):
            raise ValueError(
                f"resident-pipeline-depth must be in [0, 4] "
                f"(got {self.resident_pipeline_depth})")
        if not (0 <= self.insert_pipeline_depth <= 3):
            raise ValueError(
                f"insert-pipeline-depth must be in [0, 3] "
                f"(got {self.insert_pipeline_depth})")
        if self.resident_template_residency not in (True, False):
            raise ValueError(
                f"resident-template-residency must be a boolean "
                f"(got {self.resident_template_residency!r})")
        if self.resident_mesh_devices not in (0, 1, 2, 4, 8):
            raise ValueError(
                f"resident-mesh-devices must be one of 0, 1, 2, 4, 8 "
                f"(widths must divide the 16-lane planner bucket; got "
                f"{self.resident_mesh_devices})")
        if not (0 <= self.evm_parallel_workers <= 64):
            raise ValueError(
                f"evm-parallel-workers must be in [0, 64] "
                f"(got {self.evm_parallel_workers})")
        if not (0 <= self.evm_exec_shards <= 16):
            raise ValueError(
                f"evm-exec-shards must be in [0, 16] "
                f"(got {self.evm_exec_shards})")
        if self.device_call_timeout < 0:
            raise ValueError(
                f"device-call-timeout must be >= 0 "
                f"(got {self.device_call_timeout})")
        if self.device_max_retries != 0:
            raise ValueError(
                f"device-max-retries must be 0: the port retries no device "
                f"dispatch, a device fault reaches the caller (ROADMAP "
                f"Queue 3; got {self.device_max_retries})")
        if self.device_promote_after <= 0:
            raise ValueError(
                f"device-promote-after must be > 0 "
                f"(got {self.device_promote_after})")
        if self.resident_spot_check_interval < 0:
            raise ValueError(
                f"resident-spot-check-interval must be >= 0 "
                f"(got {self.resident_spot_check_interval})")
        if self.tail_join_timeout < 0:
            raise ValueError(
                f"tail-join-timeout must be >= 0 "
                f"(got {self.tail_join_timeout})")
        if self.db_retry_budget < 0:
            raise ValueError(
                f"db-retry-budget must be >= 0 "
                f"(got {self.db_retry_budget})")
        if self.state_backend not in ("mpt", "bintrie-shadow"):
            raise ValueError(
                f"state-backend must be 'mpt' or 'bintrie-shadow' "
                f"(got {self.state_backend!r})")
        if self.shadow_check_interval < 0:
            raise ValueError(
                f"shadow-check-interval must be >= 0 "
                f"(got {self.shadow_check_interval})")
        if self.span_ring_size <= 0:
            raise ValueError(
                f"span-ring-size must be > 0 (got {self.span_ring_size})")
        if self.trace_ring_size <= 0:
            raise ValueError(
                f"trace-ring-size must be > 0 (got {self.trace_ring_size})")
        if self.rpc_slo_budget < 0:
            raise ValueError(
                f"rpc-slo-budget must be >= 0 (got {self.rpc_slo_budget})")
        if self.chain_insert_slo_budget < 0:
            raise ValueError(
                f"chain-insert-slo-budget must be >= 0 "
                f"(got {self.chain_insert_slo_budget})")
        if self.profiler_hz < 0 or self.profiler_hz > 1000:
            raise ValueError(
                f"profiler-hz must be in [0, 1000] (got {self.profiler_hz})")
        if self.profiler_ring_size <= 0:
            raise ValueError(
                f"profiler-ring-size must be > 0 "
                f"(got {self.profiler_ring_size})")
        if self.lock_slow_hold_budget < 0:
            raise ValueError(
                f"lock-slow-hold-budget must be >= 0 "
                f"(got {self.lock_slow_hold_budget})")
        if self.flight_recorder_size <= 0:
            raise ValueError(
                f"flight-recorder-size must be > 0 "
                f"(got {self.flight_recorder_size})")
        if not (0 <= self.metrics_http_port <= 65535):
            raise ValueError(
                f"metrics-http-port must be in [0, 65535] "
                f"(got {self.metrics_http_port})")
        if self.api_max_duration < 0:
            raise ValueError(
                f"api-max-duration must be >= 0 (got {self.api_max_duration})")
        if self.api_max_blocks_per_request < 0:
            raise ValueError(
                f"api-max-blocks-per-request must be >= 0 "
                f"(got {self.api_max_blocks_per_request})")
        if self.gasprice_cache_size < 0:
            raise ValueError(
                f"gasprice-cache-size must be >= 0 "
                f"(got {self.gasprice_cache_size})")
        if self.logs_cache_size < 0:
            raise ValueError(
                f"logs-cache-size must be >= 0 "
                f"(got {self.logs_cache_size})")
        for knob in ("rpc_max_workers", "rpc_expensive_duration",
                     "rpc_batch_limit", "rpc_body_limit",
                     "rpc_breaker_threshold", "rpc_drain_timeout",
                     "rpc_max_connections", "ws_notify_queue_size"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob.replace('_', '-')} must be >= 0 "
                    f"(got {getattr(self, knob)})")
        if self.rpc_max_workers > 0:
            for knob in ("rpc_queue_size", "rpc_expensive_workers",
                         "rpc_expensive_queue_size"):
                if getattr(self, knob) < 1:
                    raise ValueError(
                        f"{knob.replace('_', '-')} must be >= 1 when "
                        f"rpc-max-workers > 0 (got {getattr(self, knob)})")
        for knob in ("rpc_breaker_probe_every", "rpc_breaker_close_after"):
            if getattr(self, knob) < 1:
                raise ValueError(
                    f"{knob.replace('_', '-')} must be >= 1 "
                    f"(got {getattr(self, knob)})")
        for knob in ("sync_backoff_base", "sync_backoff_cap",
                     "sync_leafs_deadline", "sync_blocks_deadline",
                     "sync_code_deadline", "sync_hedge_delay",
                     "sync_quarantine_seconds"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"{knob.replace('_', '-')} must be >= 0 "
                    f"(got {getattr(self, knob)})")
        for knob in ("sync_max_attempts", "sync_stale_root_votes",
                     "sync_readmit_probes"):
            if getattr(self, knob) < 1:
                raise ValueError(
                    f"{knob.replace('_', '-')} must be >= 1 "
                    f"(got {getattr(self, knob)})")
        if self.sync_backoff_cap < self.sync_backoff_base:
            raise ValueError(
                f"sync-backoff-cap ({self.sync_backoff_cap}) must be >= "
                f"sync-backoff-base ({self.sync_backoff_base})")
        if not (0 < self.sync_suspect_score <= self.sync_quarantine_score):
            raise ValueError(
                f"need 0 < sync-suspect-score <= sync-quarantine-score "
                f"(got {self.sync_suspect_score} / "
                f"{self.sync_quarantine_score})")
        if self.resident_account_trie is True and not self.pruning_enabled:
            raise ValueError(
                "resident-account-trie requires pruning: interval "
                "persistence cannot honor the archival every-block-on-disk "
                "guarantee"
            )
        for item, knobs in NOT_PORTED:
            for knob in knobs:
                val = getattr(self, knob)
                if val != _DEFAULTS[knob]:
                    raise NotImplementedError(
                        f"{knob.replace('_', '-')}={val!r} is not ported "
                        f"(ROADMAP 'Still to port', item {item})")


# (ROADMAP "Still to port" item, knobs): each raises away from its default
NOT_PORTED = (
    ("10 (config.go knobs that neither package's VM, chain, RPC tier or "
     "gossiper reads)",
     ("remote_gossip_only_enabled", "regossip_tx_queue_size",
      "trie_clean_cache", "trie_dirty_commit_target", "snapshot_cache",
      "accepted_cache_size", "allow_unprotected_txs", "preimages_enabled",
      "snapshot_async", "snapshot_verification_enabled",
      "accepted_queue_limit", "allow_missing_tries", "offline_pruning_enabled",
      "offline_pruning_bloom_filter_size", "offline_pruning_data_directory",
      "local_txs_enabled", "log_json_format",
      "keystore_insecure_unlock_allowed", "state_sync_enabled",
      "state_sync_skip_resume", "state_sync_server_trie_cache",
      "state_sync_ids", "state_sync_min_blocks",
      "max_outbound_active_requests",
      "max_outbound_active_cross_chain_requests")),
)

_DEFAULTS = {f.name: getattr(Config(), f.name) for f in fields(Config)}


def parse_config(config_bytes: bytes) -> Config:
    """Decode the Initialize JSON blob, applying defaults for absent keys
    (vm.go:326-334). JSON keys are the reference's kebab-case names."""
    cfg = Config()
    cfg.explicit_keys = set()
    if not config_bytes:
        return cfg
    raw = json.loads(config_bytes)
    key_map = {f.name.replace("_", "-"): f.name for f in fields(Config)}
    for k, v in raw.items():
        attr = key_map.get(k)
        if attr is None:
            continue  # unknown keys are ignored like the reference
        setattr(cfg, attr, v)
        cfg.explicit_keys.add(attr)
    cfg.validate()
    return cfg
