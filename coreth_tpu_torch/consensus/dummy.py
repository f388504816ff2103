"""Avalanche "dummy" consensus engine (semantics of coreth consensus/
dummy/{consensus,dynamic_fees}.go).

No PoW: Snowman provides finality, so the engine only checks header shape,
the EIP-1559-style dynamic fee over a 10-second rolling gas window
(dynamic_fees.go:40-186), the AP4 block-fee requirement (consensus.go:268),
and runs the VM's atomic-tx callbacks in Finalize/FinalizeAndAssemble
(consensus.go:336,392).

Counterpart of coreth_tpu/consensus/dummy.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from .. import params
from ..core.types import Block, Header

LONG_LEN = 8
MAX_UINT64 = (1 << 64) - 1

AP3_BLOCK_GAS_FEE = 1_000_000

# consensus modes (consensus.go:63-81 fakers)
MODE_NORMAL = "normal"
MODE_SKIP_HEADER = "skip-header"       # NewFaker: trust header gas fields
MODE_SKIP_BLOCK_FEE = "skip-block-fee"
MODE_FULL_FAKE = "full-fake"           # NewFullFaker: no verification at all


class ConsensusError(Exception):
    pass


# --- rolling gas window (dynamic_fees.go:216-283) -------------------------


def roll_long_window(window: bytes, roll: int) -> bytearray:
    res = bytearray(len(window))
    bound = roll * LONG_LEN
    if bound <= len(window):
        res[: len(window) - bound] = window[bound:]
    return res


def sum_long_window(window: bytes, num: int) -> int:
    total = 0
    for i in range(num):
        total += int.from_bytes(window[i * LONG_LEN : (i + 1) * LONG_LEN], "big")
    return min(total, MAX_UINT64)


def update_long_window(window: bytearray, start: int, value: int) -> None:
    prev = int.from_bytes(window[start : start + LONG_LEN], "big")
    new = min(prev + value, MAX_UINT64)
    window[start : start + LONG_LEN] = new.to_bytes(LONG_LEN, "big")


def _bounded(lower: Optional[int], value: int, upper: Optional[int]) -> int:
    if lower is not None and value < lower:
        return lower
    if upper is not None and value > upper:
        return upper
    return value


def calc_block_gas_cost(
    target_block_rate: int,
    min_block_gas_cost: int,
    max_block_gas_cost: int,
    block_gas_cost_step: int,
    parent_block_gas_cost: Optional[int],
    parent_time: int,
    current_time: int,
) -> int:
    """calcBlockGasCost (dynamic_fees.go:286-319): cost rises when blocks
    come faster than the 2s target, decays when slower."""
    if parent_block_gas_cost is None:
        return min_block_gas_cost
    time_elapsed = current_time - parent_time if parent_time <= current_time else 0
    if time_elapsed < target_block_rate:
        cost = parent_block_gas_cost + block_gas_cost_step * (target_block_rate - time_elapsed)
    else:
        cost = parent_block_gas_cost - block_gas_cost_step * (time_elapsed - target_block_rate)
    cost = _bounded(min_block_gas_cost, cost, max_block_gas_cost)
    return min(cost, MAX_UINT64)


def block_gas_cost(config, parent: Header, timestamp: int) -> int:
    """BlockGasCost wrapper selecting the AP4/AP5 step."""
    step = (
        params.AP5_BLOCK_GAS_COST_STEP
        if config.is_apricot_phase5(timestamp)
        else params.AP4_BLOCK_GAS_COST_STEP
    )
    return calc_block_gas_cost(
        params.AP4_TARGET_BLOCK_RATE,
        params.AP4_MIN_BLOCK_GAS_COST,
        params.AP4_MAX_BLOCK_GAS_COST,
        step,
        parent.block_gas_cost,
        parent.time,
        timestamp,
    )


def calc_base_fee(config, parent: Header, timestamp: int) -> Tuple[bytes, int]:
    """CalcBaseFee (dynamic_fees.go:40-186): returns (new extra-data window,
    base fee) for a child of [parent] at [timestamp]."""
    is_ap3 = config.is_apricot_phase3(parent.time)
    is_ap4 = config.is_apricot_phase4(parent.time)
    is_ap5 = config.is_apricot_phase5(parent.time)

    if not is_ap3 or parent.number == 0:
        return bytes(params.APRICOT_PHASE3_EXTRA_DATA_SIZE), params.APRICOT_PHASE3_INITIAL_BASE_FEE
    if len(parent.extra) != params.APRICOT_PHASE3_EXTRA_DATA_SIZE:
        raise ConsensusError(
            f"expected parent extra data {params.APRICOT_PHASE3_EXTRA_DATA_SIZE} bytes, got {len(parent.extra)}"
        )
    if timestamp < parent.time:
        raise ConsensusError(f"timestamp {timestamp} before parent {parent.time}")
    roll = timestamp - parent.time

    window = roll_long_window(parent.extra, roll)

    base_fee = parent.base_fee
    denominator = (
        params.APRICOT_PHASE5_BASE_FEE_CHANGE_DENOMINATOR
        if is_ap5
        else params.APRICOT_PHASE4_BASE_FEE_CHANGE_DENOMINATOR
    )
    gas_target = params.APRICOT_PHASE5_TARGET_GAS if is_ap5 else params.APRICOT_PHASE3_TARGET_GAS

    if roll < params.ROLLUP_WINDOW:
        block_cost = 0
        ext_gas_used = 0
        if is_ap5:
            ext_gas_used = parent.ext_data_gas_used or 0
        elif is_ap4:
            block_cost = calc_block_gas_cost(
                params.AP4_TARGET_BLOCK_RATE,
                params.AP4_MIN_BLOCK_GAS_COST,
                params.AP4_MAX_BLOCK_GAS_COST,
                params.AP4_BLOCK_GAS_COST_STEP,
                parent.block_gas_cost,
                parent.time,
                timestamp,
            )
            ext_gas_used = parent.ext_data_gas_used or 0
        else:
            block_cost = AP3_BLOCK_GAS_FEE
        added = min(parent.gas_used + ext_gas_used, MAX_UINT64)
        if not is_ap5:
            added = min(added + block_cost, MAX_UINT64)
        slot = params.ROLLUP_WINDOW - 1 - roll
        update_long_window(window, slot * LONG_LEN, added)

    total_gas = sum_long_window(window, params.ROLLUP_WINDOW)
    if total_gas == gas_target:
        return bytes(window), base_fee

    if total_gas > gas_target:
        delta = max(base_fee * (total_gas - gas_target) // gas_target // denominator, 1)
        base_fee += delta
    else:
        delta = max(base_fee * (gas_target - total_gas) // gas_target // denominator, 1)
        if roll > params.ROLLUP_WINDOW:
            delta *= roll // params.ROLLUP_WINDOW
        base_fee -= delta

    if is_ap5:
        base_fee = _bounded(params.APRICOT_PHASE4_MIN_BASE_FEE, base_fee, None)
    elif is_ap4:
        base_fee = _bounded(
            params.APRICOT_PHASE4_MIN_BASE_FEE, base_fee, params.APRICOT_PHASE4_MAX_BASE_FEE
        )
    else:
        base_fee = _bounded(
            params.APRICOT_PHASE3_MIN_BASE_FEE, base_fee, params.APRICOT_PHASE3_MAX_BASE_FEE
        )
    return bytes(window), base_fee


def estimate_next_base_fee(config, parent: Header, timestamp: int) -> Tuple[bytes, int]:
    if timestamp < parent.time:
        timestamp = parent.time
    return calc_base_fee(config, parent, timestamp)


def min_required_tip(config, header: Header) -> Optional[int]:
    """MinRequiredTip (dynamic_fees.go:321+): estimated min tip for
    inclusion given the header's blockGasCost."""
    if not config.is_apricot_phase4(header.time) or header.base_fee is None:
        return None
    if header.block_gas_cost is None:
        return None
    total_gas_used = header.gas_used + (header.ext_data_gas_used or 0)
    if total_gas_used == 0:
        return None
    required_block_fee = header.block_gas_cost * header.base_fee
    return (required_block_fee + total_gas_used - 1) // total_gas_used


# --- engine ---------------------------------------------------------------


@dataclass
class ConsensusCallbacks:
    """VM hooks for atomic txs (consensus.go OnFinalizeAndAssemble/OnExtraStateChange,
    wired at plugin/evm/vm.go:696-851)."""

    on_finalize_and_assemble: Optional[Callable] = None  # (header, state, txs) -> (extdata, contribution, extGasUsed)
    on_extra_state_change: Optional[Callable] = None     # (block, state) -> (contribution, extGasUsed)


class DummyEngine:
    def __init__(self, cb: Optional[ConsensusCallbacks] = None, mode: str = MODE_NORMAL):
        self.cb = cb or ConsensusCallbacks()
        self.mode = mode

    # --- header verification (consensus.go:88-236) ------------------------

    def verify_header(self, config, header: Header, parent: Header,
                      uncle: bool = False) -> None:
        if self.mode == MODE_FULL_FAKE:
            return
        timestamp = header.time
        if self.mode != MODE_SKIP_HEADER:
            self._verify_header_gas_fields(config, header, parent)
        # timestamp checks: child at or after parent (no future bound here;
        # the VM checks clock skew)
        if header.time < parent.time:
            raise ConsensusError("timestamp before parent")
        if header.number != parent.number + 1:
            raise ConsensusError("invalid block number")
        # extra-data size per fork (consensus.go:147-166)
        if config.is_apricot_phase3(timestamp):
            if len(header.extra) != params.APRICOT_PHASE3_EXTRA_DATA_SIZE:
                raise ConsensusError(
                    f"expected extra-data field length 80, got {len(header.extra)}"
                )
        else:
            if len(header.extra) > 32:
                raise ConsensusError("extra-data too long")

    def _verify_header_gas_fields(self, config, header: Header, parent: Header) -> None:
        timestamp = header.time
        # gas limit per fork (consensus.go:92-130)
        if config.is_cortina(timestamp):
            if header.gas_limit != params.CORTINA_GAS_LIMIT:
                raise ConsensusError(
                    f"expected gas limit {params.CORTINA_GAS_LIMIT}, got {header.gas_limit}"
                )
        elif config.is_apricot_phase1(timestamp):
            if header.gas_limit != params.APRICOT_PHASE1_GAS_LIMIT:
                raise ConsensusError(
                    f"expected gas limit {params.APRICOT_PHASE1_GAS_LIMIT}, got {header.gas_limit}"
                )
        else:
            if header.gas_limit < params.MIN_GAS_LIMIT or header.gas_limit > params.MAX_GAS_LIMIT:
                raise ConsensusError("invalid gas limit")
            diff = abs(header.gas_limit - parent.gas_limit)
            if diff >= parent.gas_limit // params.GAS_LIMIT_BOUND_DIVISOR:
                raise ConsensusError("gas limit delta out of bounds")
        if header.gas_used > header.gas_limit:
            raise ConsensusError("gas used exceeds gas limit")
        # base fee + rollup window bytes (consensus.go:118-146): the extra
        # field IS consensus state — descendants derive fees from it
        if config.is_apricot_phase3(timestamp):
            expected_window, expected_base_fee = calc_base_fee(config, parent, timestamp)
            if header.extra != expected_window:
                raise ConsensusError(
                    f"expected extra-data window {expected_window.hex()}, "
                    f"got {header.extra.hex()}"
                )
            if header.base_fee != expected_base_fee:
                raise ConsensusError(
                    f"expected base fee {expected_base_fee}, got {header.base_fee}"
                )
        elif header.base_fee is not None:
            raise ConsensusError("base fee before AP3")
        # blockGasCost / extDataGasUsed (consensus.go:168-208)
        if config.is_apricot_phase4(timestamp):
            expected_cost = block_gas_cost(config, parent, timestamp)
            if header.block_gas_cost != expected_cost:
                raise ConsensusError(
                    f"expected blockGasCost {expected_cost}, got {header.block_gas_cost}"
                )
            if header.ext_data_gas_used is None:
                raise ConsensusError("extDataGasUsed missing post-AP4")
        else:
            if header.block_gas_cost is not None:
                raise ConsensusError("blockGasCost before AP4")
            if header.ext_data_gas_used is not None:
                raise ConsensusError("extDataGasUsed before AP4")

    # --- block fee (consensus.go:268-334) ---------------------------------

    def verify_block_fee(self, base_fee: Optional[int], required_block_gas_cost: Optional[int],
                         txs, receipts, extra_contribution: Optional[int]) -> None:
        if self.mode in (MODE_SKIP_BLOCK_FEE, MODE_FULL_FAKE):
            return
        if base_fee is None or base_fee <= 0:
            raise ConsensusError(f"invalid base fee {base_fee} in AP4")
        if required_block_gas_cost is None or required_block_gas_cost > MAX_UINT64:
            raise ConsensusError("invalid block gas cost")
        total_block_fee = 0
        if extra_contribution is not None:
            if extra_contribution < 0:
                raise ConsensusError("invalid extra state contribution")
            total_block_fee += extra_contribution
        for tx, receipt in zip(txs, receipts):
            premium = tx.effective_gas_tip(base_fee)
            if premium < 0:
                raise ConsensusError("negative effective tip")
            total_block_fee += premium * receipt.gas_used
        block_gas = total_block_fee // base_fee
        if block_gas < required_block_gas_cost:
            raise ConsensusError(
                f"insufficient gas ({block_gas}) to cover the block cost "
                f"({required_block_gas_cost}) at base fee ({base_fee})"
            )

    # --- finalize (consensus.go:336-446) ----------------------------------

    def finalize(self, chain_config, block: Block, parent: Header, state,
                 receipts) -> None:
        """Verify-side finalize: run atomic-tx extra state change, verify
        extDataGasUsed/blockGasCost and the block fee."""
        contribution, ext_gas_used = None, None
        if self.cb.on_extra_state_change is not None:
            contribution, ext_gas_used = self.cb.on_extra_state_change(block, state)
        timestamp = block.time
        if chain_config.is_apricot_phase4(timestamp):
            header_ext = block.header.ext_data_gas_used or 0
            if chain_config.is_apricot_phase5(timestamp):
                if header_ext != (ext_gas_used or 0):
                    raise ConsensusError(
                        f"extDataGasUsed mismatch: have {header_ext} want {ext_gas_used or 0}"
                    )
                if header_ext > params.ATOMIC_GAS_LIMIT:
                    raise ConsensusError("extDataGasUsed exceeds atomic gas limit")
            elif header_ext != (ext_gas_used or 0):
                raise ConsensusError("extDataGasUsed mismatch")
            self.verify_block_fee(
                block.base_fee, block.header.block_gas_cost,
                block.transactions, receipts, contribution,
            )

    def finalize_and_assemble(self, chain_config, header: Header, parent: Header,
                              state, txs, receipts) -> Block:
        """Build-side finalize: pull atomic txs via callback, set gas-cost
        fields, verify fee, assemble the block with the final state root."""
        ext_data, contribution, ext_gas_used = b"", None, None
        if self.cb.on_finalize_and_assemble is not None:
            ext_data, contribution, ext_gas_used = self.cb.on_finalize_and_assemble(
                header, state, txs
            )
        timestamp = header.time
        if chain_config.is_apricot_phase4(timestamp):
            header.ext_data_gas_used = ext_gas_used or 0
            header.block_gas_cost = block_gas_cost(chain_config, parent, timestamp)
            self.verify_block_fee(
                header.base_fee, header.block_gas_cost, txs, receipts, contribution,
            )
        header.root = state.intermediate_root(chain_config.is_eip158(header.number))
        return Block.assemble(header, txs, receipts, ext_data or None)


def new_faker() -> DummyEngine:
    return DummyEngine(mode=MODE_SKIP_HEADER)


def new_eth_faker() -> DummyEngine:
    return DummyEngine(mode=MODE_SKIP_BLOCK_FEE)


def new_full_faker() -> DummyEngine:
    return DummyEngine(mode=MODE_FULL_FAKE)


def new_dummy_engine(cb: ConsensusCallbacks = None) -> DummyEngine:
    return DummyEngine(cb)
