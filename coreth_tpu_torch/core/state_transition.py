"""Message → EVM state transition (semantics of coreth core/
state_transition.go + core/gaspool.go).

ApplyMessage: preCheck (nonce/EOA/fee-cap/funds — :261-335) → buy gas →
intrinsic gas → EVM Create/Call → refund (removed at ApricotPhase1 —
:402-420) → fee to coinbase (the blackhole address on Avalanche, so fees
are burned — :393).

Counterpart of coreth_tpu/core/state_transition.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import params, vmerrs
from ..evm.evm import EVM, BLACKHOLE_ADDR
from ..evm.precompiles import GENESIS_CONTRACT_ADDR
from ..native import keccak256

EMPTY_CODE_HASH = keccak256(b"")


class TxValidationError(Exception):
    """Consensus-level tx rejection (core/error.go sentinels)."""


ErrNonceTooLow = "nonce too low"
ErrNonceTooHigh = "nonce too high"
ErrNonceMax = "nonce has max value"
ErrInsufficientFunds = "insufficient funds for gas * price + value"
ErrInsufficientFundsForTransfer = "insufficient funds for transfer"
ErrIntrinsicGas = "intrinsic gas too low"
ErrGasLimitReached = "gas limit reached"
ErrSenderNoEOA = "sender not an EOA"
ErrFeeCapTooLow = "max fee per gas less than block base fee"
ErrTipAboveFeeCap = "max priority fee per gas higher than max fee per gas"


# reserved precompile address ranges (precompile/params.go): 0x01000...00 –
# 0x0100...ff and 0x0200...00 – 0x0200...ff
def is_prohibited(addr: bytes) -> bool:
    """vm.IsProhibited (evm.go:50-60)."""
    if addr == BLACKHOLE_ADDR:
        return True
    return addr[:19] in (b"\x01" + b"\x00" * 18, b"\x02" + b"\x00" * 18)


@dataclass
class Message:
    """core.Message (state_transition.go:12x): a tx unpacked for execution."""

    from_: bytes
    to: Optional[bytes]  # None = contract creation
    nonce: int = 0
    value: int = 0
    gas_limit: int = 21000
    gas_price: int = 0
    gas_fee_cap: Optional[int] = None
    gas_tip_cap: Optional[int] = None
    data: bytes = b""
    access_list: List = field(default_factory=list)
    skip_account_checks: bool = False


def tx_as_message(tx, signer, base_fee: Optional[int]):
    """TransactionToMessage: recover sender + compute effective gas price."""
    return Message(
        from_=signer.sender(tx),
        to=tx.to,
        nonce=tx.nonce,
        value=tx.value,
        gas_limit=tx.gas,
        gas_price=tx.effective_gas_price(base_fee),
        gas_fee_cap=tx.gas_fee_cap,
        gas_tip_cap=tx.gas_tip_cap,
        data=tx.data,
        access_list=list(tx.access_list or []),
    )


class GasPool:
    """Block gas counter (core/gaspool.go)."""

    def __init__(self, gas: int):
        self.gas = gas

    def sub_gas(self, amount: int) -> None:
        if self.gas < amount:
            raise TxValidationError(ErrGasLimitReached)
        self.gas -= amount

    def add_gas(self, amount: int) -> None:
        self.gas += amount


def intrinsic_gas(data: bytes, access_list, is_creation: bool,
                  is_homestead: bool, is_eip2028: bool, is_eip3860: bool) -> int:
    """IntrinsicGas (state_transition.go:77-125)."""
    gas = params.TX_GAS_CONTRACT_CREATION if (is_creation and is_homestead) else params.TX_GAS
    if data:
        nz = sum(1 for b in data if b != 0)
        nonzero_gas = params.TX_DATA_NON_ZERO_GAS_EIP2028 if is_eip2028 else params.TX_DATA_NON_ZERO_GAS_FRONTIER
        gas += nz * nonzero_gas
        gas += (len(data) - nz) * params.TX_DATA_ZERO_GAS
        if is_creation and is_eip3860:
            gas += ((len(data) + 31) // 32) * params.INIT_CODE_WORD_GAS
    if access_list:
        gas += len(access_list) * params.TX_ACCESS_LIST_ADDRESS_GAS
        gas += sum(len(keys) for _addr, keys in access_list) * params.TX_ACCESS_LIST_STORAGE_KEY_GAS
    return gas


@dataclass
class ExecutionResult:
    used_gas: int
    err: Optional[Exception]  # VM error (consensus-irrelevant)
    return_data: bytes

    @property
    def failed(self) -> bool:
        return self.err is not None

    def revert_reason(self) -> bytes:
        return self.return_data if vmerrs.is_revert(self.err) else b""


class StateTransition:
    def __init__(self, evm: EVM, msg: Message, gp: GasPool):
        self.evm = evm
        self.msg = msg
        self.gp = gp
        self.state = evm.statedb
        self.gas_remaining = 0
        self.initial_gas = 0

    def gas_used(self) -> int:
        return self.initial_gas - self.gas_remaining

    # --- preCheck + buyGas (state_transition.go:239-335) ------------------

    def _buy_gas(self) -> None:
        msg = self.msg
        mgval = msg.gas_limit * msg.gas_price
        balance_check = mgval
        if msg.gas_fee_cap is not None:
            balance_check = msg.gas_limit * msg.gas_fee_cap + msg.value
        if self.state.get_balance(msg.from_) < balance_check:
            raise TxValidationError(
                f"{ErrInsufficientFunds}: have {self.state.get_balance(msg.from_)} want {balance_check}"
            )
        self.gp.sub_gas(msg.gas_limit)
        self.gas_remaining = msg.gas_limit
        self.initial_gas = msg.gas_limit
        self.state.sub_balance(msg.from_, mgval)

    def _pre_check(self) -> None:
        msg = self.msg
        if not msg.skip_account_checks:
            st_nonce = self.state.get_nonce(msg.from_)
            if st_nonce < msg.nonce:
                raise TxValidationError(f"{ErrNonceTooHigh}: tx {msg.nonce} state {st_nonce}")
            if st_nonce > msg.nonce:
                raise TxValidationError(f"{ErrNonceTooLow}: tx {msg.nonce} state {st_nonce}")
            if st_nonce + 1 >= 1 << 64:
                raise TxValidationError(ErrNonceMax)
            code_hash = self.state.get_code_hash(msg.from_)
            if code_hash not in (b"", b"\x00" * 32, EMPTY_CODE_HASH):
                raise TxValidationError(ErrSenderNoEOA)
            if is_prohibited(msg.from_):
                raise TxValidationError(str(vmerrs.ErrAddrProhibited))
        if self.evm.rules.is_apricot_phase3:
            if not self.evm.config.no_base_fee or msg.gas_fee_cap or msg.gas_tip_cap:
                # legacy txs carry their gas price as both caps
                fee_cap = msg.gas_fee_cap if msg.gas_fee_cap is not None else msg.gas_price
                tip_cap = msg.gas_tip_cap if msg.gas_tip_cap is not None else msg.gas_price
                if fee_cap < tip_cap:
                    raise TxValidationError(ErrTipAboveFeeCap)
                if fee_cap < (self.evm.block_ctx.base_fee or 0):
                    raise TxValidationError(
                        f"{ErrFeeCapTooLow}: maxFeePerGas {fee_cap} baseFee {self.evm.block_ctx.base_fee}"
                    )
        self._buy_gas()

    # --- TransitionDb (state_transition.go:338-400) -----------------------

    def transition_db(self) -> ExecutionResult:
        self._pre_check()
        msg = self.msg
        rules = self.evm.rules
        contract_creation = msg.to is None

        gas = intrinsic_gas(
            msg.data, msg.access_list, contract_creation,
            rules.is_homestead, rules.is_istanbul, rules.is_d_upgrade,
        )
        if self.gas_remaining < gas:
            raise TxValidationError(f"{ErrIntrinsicGas}: have {self.gas_remaining} want {gas}")
        self.gas_remaining -= gas

        if msg.value > 0 and not self.evm.block_ctx.can_transfer(self.state, msg.from_, msg.value):
            raise TxValidationError(ErrInsufficientFundsForTransfer)

        if rules.is_d_upgrade and contract_creation and len(msg.data) > params.MAX_INIT_CODE_SIZE:
            raise TxValidationError(str(vmerrs.ErrMaxInitCodeSizeExceeded))

        # access-list + transient-storage prep (statedb.Prepare)
        self.state.prepare(
            rules, msg.from_, self.evm.block_ctx.coinbase, msg.to,
            list(self.evm.precompiles.keys()), msg.access_list,
        )

        if contract_creation:
            ret, _, self.gas_remaining, vmerr = self.evm.create(
                msg.from_, msg.data, self.gas_remaining, msg.value
            )
        else:
            self.state.set_nonce(msg.from_, self.state.get_nonce(msg.from_) + 1)
            ret, self.gas_remaining, vmerr = self.evm.call(
                msg.from_, msg.to, msg.data, self.gas_remaining, msg.value
            )

        self._refund_gas(rules.is_apricot_phase1)
        self.state.add_balance(
            self.evm.block_ctx.coinbase, self.gas_used() * msg.gas_price
        )
        return ExecutionResult(self.gas_used(), vmerr, ret)

    def _refund_gas(self, apricot_phase1: bool) -> None:
        if not apricot_phase1:
            refund = min(self.gas_used() // 2, self.state.get_refund())
            self.gas_remaining += refund
        self.state.add_balance(self.msg.from_, self.gas_remaining * self.msg.gas_price)
        self.gp.add_gas(self.gas_remaining)


def apply_message(evm: EVM, msg: Message, gp: GasPool) -> ExecutionResult:
    """core.ApplyMessage."""
    return StateTransition(evm, msg, gp).transition_db()
