"""Chain configuration & fork schedule (semantics of coreth params/);
counterpart of coreth_tpu/params/__init__.py.

ChainConfig carries Ethereum fork block numbers plus the Avalanche fork
timestamps (ApricotPhase1-6/Pre6/Post6, Banff, Cortina, DUpgrade —
params/config.go:514-535); Rules snapshots the active forks for one
(block number, timestamp). Protocol constants from avalanche_params.go
and protocol_params.go. Stateful precompiles (precompile/) register
through `precompile_upgrades` and activate in check_configure_precompiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# --- gas / protocol constants (protocol_params.go, avalanche_params.go) ----
GAS_LIMIT_BOUND_DIVISOR = 1024
MIN_GAS_LIMIT = 5000
MAX_GAS_LIMIT = 0x7FFFFFFFFFFFFFFF
GENESIS_GAS_LIMIT = 4_712_388

MAX_CODE_SIZE = 24576
MAX_INIT_CODE_SIZE = 2 * MAX_CODE_SIZE

TX_GAS = 21000
TX_GAS_CONTRACT_CREATION = 53000
TX_DATA_ZERO_GAS = 4
TX_DATA_NON_ZERO_GAS_FRONTIER = 68
TX_DATA_NON_ZERO_GAS_EIP2028 = 16
TX_ACCESS_LIST_ADDRESS_GAS = 2400
TX_ACCESS_LIST_STORAGE_KEY_GAS = 1900
INIT_CODE_WORD_GAS = 2

LAUNCH_MIN_GAS_PRICE = 470_000_000_000
APRICOT_PHASE1_MIN_GAS_PRICE = 225_000_000_000
APRICOT_PHASE1_GAS_LIMIT = 8_000_000
CORTINA_GAS_LIMIT = 15_000_000

APRICOT_PHASE3_EXTRA_DATA_SIZE = 80
APRICOT_PHASE3_MIN_BASE_FEE = 75_000_000_000
APRICOT_PHASE3_MAX_BASE_FEE = 225_000_000_000
APRICOT_PHASE3_INITIAL_BASE_FEE = 225_000_000_000
APRICOT_PHASE3_TARGET_GAS = 10_000_000
APRICOT_PHASE4_MIN_BASE_FEE = 25_000_000_000
APRICOT_PHASE4_MAX_BASE_FEE = 1_000_000_000_000
APRICOT_PHASE4_BASE_FEE_CHANGE_DENOMINATOR = 12
APRICOT_PHASE5_TARGET_GAS = 15_000_000
APRICOT_PHASE5_BASE_FEE_CHANGE_DENOMINATOR = 36

ATOMIC_TX_BASE_COST = 10_000
ATOMIC_GAS_LIMIT = 100_000

# rolling-window fee algo (consensus/dummy/dynamic_fees.go:33)
ROLLUP_WINDOW = 10

# AP4 block gas cost params (dynamic_fees.go)
AP4_MIN_BLOCK_GAS_COST = 0
AP4_MAX_BLOCK_GAS_COST = 1_000_000
AP4_BLOCK_GAS_COST_STEP = 50_000
AP4_TARGET_BLOCK_RATE = 2  # seconds
AP5_BLOCK_GAS_COST_STEP = 200_000


@dataclass
class ChainConfig:
    chain_id: int = 1

    # Ethereum forks (block numbers; None = never). The Avalanche configs
    # activate all of these at genesis (params/config.go:108-133).
    homestead_block: Optional[int] = 0
    eip150_block: Optional[int] = 0
    eip155_block: Optional[int] = 0
    eip158_block: Optional[int] = 0
    byzantium_block: Optional[int] = 0
    constantinople_block: Optional[int] = 0
    petersburg_block: Optional[int] = 0
    istanbul_block: Optional[int] = 0
    muir_glacier_block: Optional[int] = 0

    # Avalanche forks (timestamps; None = never)
    apricot_phase1_time: Optional[int] = None
    apricot_phase2_time: Optional[int] = None
    apricot_phase3_time: Optional[int] = None
    apricot_phase4_time: Optional[int] = None
    apricot_phase5_time: Optional[int] = None
    apricot_phase_pre6_time: Optional[int] = None
    apricot_phase6_time: Optional[int] = None
    apricot_phase_post6_time: Optional[int] = None
    banff_time: Optional[int] = None
    cortina_time: Optional[int] = None
    d_upgrade_time: Optional[int] = None

    # Stateful-precompile registrations (precompile/ framework): configs
    # with .address/.timestamp/.is_activated/.configure/.contract —
    # reference params/config.go:1027-1101
    precompile_upgrades: tuple = ()

    # ---- stateful precompiles -------------------------------------------

    def enabled_stateful_precompiles(self):
        """Configs in activation order (config.go:1082-1089)."""
        return sorted(
            (c for c in self.precompile_upgrades if c.timestamp is not None),
            key=lambda c: c.timestamp,
        )

    def check_configure_precompiles(self, parent_ts: Optional[int],
                                    block_header, statedb) -> None:
        """Activate any precompile whose timestamp falls in the
        parent->block transition (config.go:1092-1101); called from the
        processor, the miner, and genesis construction."""
        from ..precompile import check_configure

        for cfg in self.enabled_stateful_precompiles():
            check_configure(self, parent_ts, block_header, cfg, statedb)

    # ---- per-block fork checks ------------------------------------------

    def _is_block(self, fork: Optional[int], number: int) -> bool:
        return fork is not None and fork <= number

    def _is_time(self, fork: Optional[int], time: int) -> bool:
        return fork is not None and fork <= time

    def is_homestead(self, n): return self._is_block(self.homestead_block, n)
    def is_eip150(self, n): return self._is_block(self.eip150_block, n)
    def is_eip155(self, n): return self._is_block(self.eip155_block, n)
    def is_eip158(self, n): return self._is_block(self.eip158_block, n)
    def is_byzantium(self, n): return self._is_block(self.byzantium_block, n)
    def is_constantinople(self, n): return self._is_block(self.constantinople_block, n)
    def is_petersburg(self, n): return self._is_block(self.petersburg_block, n)
    def is_istanbul(self, n): return self._is_block(self.istanbul_block, n)

    def is_apricot_phase1(self, t): return self._is_time(self.apricot_phase1_time, t)
    def is_apricot_phase2(self, t): return self._is_time(self.apricot_phase2_time, t)
    def is_apricot_phase3(self, t): return self._is_time(self.apricot_phase3_time, t)
    def is_apricot_phase4(self, t): return self._is_time(self.apricot_phase4_time, t)
    def is_apricot_phase5(self, t): return self._is_time(self.apricot_phase5_time, t)
    def is_apricot_phase_pre6(self, t): return self._is_time(self.apricot_phase_pre6_time, t)
    def is_apricot_phase6(self, t): return self._is_time(self.apricot_phase6_time, t)
    def is_apricot_phase_post6(self, t): return self._is_time(self.apricot_phase_post6_time, t)
    def is_banff(self, t): return self._is_time(self.banff_time, t)
    def is_cortina(self, t): return self._is_time(self.cortina_time, t)
    def is_d_upgrade(self, t): return self._is_time(self.d_upgrade_time, t)

    def rules(self, number: int, timestamp: int) -> "Rules":
        return Rules(
            chain_id=self.chain_id,
            is_homestead=self.is_homestead(number),
            is_eip150=self.is_eip150(number),
            is_eip155=self.is_eip155(number),
            is_eip158=self.is_eip158(number),
            is_byzantium=self.is_byzantium(number),
            is_constantinople=self.is_constantinople(number),
            is_petersburg=self.is_petersburg(number),
            is_istanbul=self.is_istanbul(number),
            is_apricot_phase1=self.is_apricot_phase1(timestamp),
            is_apricot_phase2=self.is_apricot_phase2(timestamp),
            is_apricot_phase3=self.is_apricot_phase3(timestamp),
            is_apricot_phase4=self.is_apricot_phase4(timestamp),
            is_apricot_phase5=self.is_apricot_phase5(timestamp),
            is_apricot_phase_pre6=self.is_apricot_phase_pre6(timestamp),
            is_apricot_phase6=self.is_apricot_phase6(timestamp),
            is_apricot_phase_post6=self.is_apricot_phase_post6(timestamp),
            is_banff=self.is_banff(timestamp),
            is_cortina=self.is_cortina(timestamp),
            is_d_upgrade=self.is_d_upgrade(timestamp),
            active_precompiles={
                cfg.address: cfg.contract()
                for cfg in self.precompile_upgrades
                if cfg.is_activated(timestamp)
            },
        )


@dataclass
class Rules:
    """Fork-rule snapshot for one block (params/config.go Rules/AvalancheRules)."""

    chain_id: int = 1
    is_homestead: bool = True
    is_eip150: bool = True
    is_eip155: bool = True
    is_eip158: bool = True
    is_byzantium: bool = True
    is_constantinople: bool = True
    is_petersburg: bool = True
    is_istanbul: bool = True
    is_apricot_phase1: bool = False
    is_apricot_phase2: bool = False
    is_apricot_phase3: bool = False
    is_apricot_phase4: bool = False
    is_apricot_phase5: bool = False
    is_apricot_phase_pre6: bool = False
    is_apricot_phase6: bool = False
    is_apricot_phase_post6: bool = False
    is_banff: bool = False
    is_cortina: bool = False
    is_d_upgrade: bool = False

    # stateful-precompile activation registry hook (precompile/ framework)
    active_precompiles: dict = field(default_factory=dict)

    # EVM aliases: Avalanche phases imply the Ethereum mainnet forks coreth
    # maps them to (params/config.go AvalancheRules)
    @property
    def is_berlin(self) -> bool:
        return self.is_apricot_phase2

    @property
    def is_london(self) -> bool:
        return self.is_apricot_phase3

    @property
    def is_shanghai(self) -> bool:
        return self.is_d_upgrade


def avalanche_local_chain_config() -> ChainConfig:
    """All forks at genesis (params/config.go:107-132 local preset)."""
    return ChainConfig(
        chain_id=43112,
        apricot_phase1_time=0, apricot_phase2_time=0, apricot_phase3_time=0,
        apricot_phase4_time=0, apricot_phase5_time=0,
        apricot_phase_pre6_time=0, apricot_phase6_time=0,
        apricot_phase_post6_time=0, banff_time=0, cortina_time=0,
        d_upgrade_time=0,
    )


def avalanche_mainnet_chain_config() -> ChainConfig:
    """Mainnet C-Chain cadence (params/config.go:53-77 timestamps)."""
    return ChainConfig(
        chain_id=43114,
        apricot_phase1_time=1617199200,
        apricot_phase2_time=1620644400,
        apricot_phase3_time=1629813600,
        apricot_phase4_time=1632344400,
        apricot_phase5_time=1638468000,
        apricot_phase_pre6_time=1662341400,
        apricot_phase6_time=1662494400,
        apricot_phase_post6_time=1662519600,
        banff_time=1666108800,
        cortina_time=1682434800,
        d_upgrade_time=None,
    )


def avalanche_fuji_chain_config() -> ChainConfig:
    """Fuji testnet cadence (params/config.go:80-105 timestamps)."""
    return ChainConfig(
        chain_id=43113,
        apricot_phase1_time=1616767200,   # 2021-03-26T14:00Z
        apricot_phase2_time=1620223200,   # 2021-05-05T14:00Z
        apricot_phase3_time=1629140400,   # 2021-08-16T19:00Z
        apricot_phase4_time=1631826000,   # 2021-09-16T21:00Z
        apricot_phase5_time=1637766000,   # 2021-11-24T15:00Z
        apricot_phase_pre6_time=1662494400,   # 2022-09-06T20:00Z
        apricot_phase6_time=1662494400,       # 2022-09-06T20:00Z
        apricot_phase_post6_time=1662530400,  # 2022-09-07T06:00Z
        banff_time=1664805600,            # 2022-10-03T14:00Z
        cortina_time=1680793200,          # 2023-04-06T15:00Z
        d_upgrade_time=None,
    )


def chain_config_for_network(network_id: int) -> ChainConfig:
    """Genesis/network -> fork schedule selection (vm.go:383-403)."""
    if network_id == 1:       # avalanche mainnet network id
        return avalanche_mainnet_chain_config()
    if network_id == 5:       # fuji network id
        return avalanche_fuji_chain_config()
    return avalanche_local_chain_config()


TEST_CHAIN_CONFIG = avalanche_local_chain_config()
