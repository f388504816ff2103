"""The EVM object: call/create dispatch, value transfer, precompile routing.

Semantics of coreth core/vm/evm.go. Carries BlockContext (coinbase,
number, time, basefee, transfer + multicoin-transfer fns — evm.go:67-121)
and TxContext (origin, gas price). Call/CallCode/DelegateCall/StaticCall/
Create/Create2 mirror evm.go:229-686; CallExpert and NativeAssetCall are
the Avalanche multicoin entry points (evm.go:411-480,688-740).

Errors flow as return values `(ret, remaining_gas, err)` at this layer —
the interpreter raises, the EVM catches and converts, exactly at the same
boundary as the reference.

Counterpart of coreth_tpu/evm/evm.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from .. import vmerrs
from ..native import keccak256
from . import gas as G
from .interpreter import (
    Contract, Interpreter, fast_table_for_rules, jump_table_for_rules,
)
from .precompiles import active_precompiles

EMPTY_CODE_HASH = keccak256(b"")
ZERO_ADDR = b"\x00" * 20

# constants.BlackholeAddr — multicoin balances are burned here on export
BLACKHOLE_ADDR = b"\x01" + b"\x00" * 19


def can_transfer(db, addr: bytes, amount: int) -> bool:
    return db.get_balance(addr) >= amount


def transfer(db, sender: bytes, recipient: bytes, amount: int) -> None:
    db.sub_balance(sender, amount)
    db.add_balance(recipient, amount)


def can_transfer_mc(db, addr: bytes, coin_id: bytes, amount: int) -> bool:
    return db.get_balance_multicoin(addr, coin_id) >= amount


def transfer_multicoin(db, sender: bytes, recipient: bytes, coin_id: bytes, amount: int) -> None:
    db.sub_balance_multicoin(sender, coin_id, amount)
    db.add_balance_multicoin(recipient, coin_id, amount)


@dataclass
class BlockContext:
    coinbase: bytes = ZERO_ADDR
    block_number: int = 0
    time: int = 0
    difficulty: int = 1
    gas_limit: int = 8_000_000
    base_fee: Optional[int] = None
    get_hash: Callable[[int], Optional[bytes]] = lambda n: None
    can_transfer: Callable = can_transfer
    transfer: Callable = transfer
    can_transfer_mc: Callable = can_transfer_mc
    transfer_multicoin: Callable = transfer_multicoin


@dataclass
class TxContext:
    origin: bytes = ZERO_ADDR
    gas_price: int = 0


@dataclass
class Config:
    """vm.Config (interpreter.go:31-45)."""

    tracer: Optional[object] = None
    no_base_fee: bool = False
    enable_preimage_recording: bool = False
    extra_eips: tuple = ()
    allow_unfinalized_queries: bool = False
    # None defers to interpreter.FASTLOOP_DEFAULT / the env override;
    # True/False pins this EVM to the fast or legacy dispatch loop
    fastloop: Optional[bool] = None


class EVM:
    """One EVM instance per transaction (evm.go:125-175)."""

    def __init__(self, block_ctx: BlockContext, tx_ctx: TxContext, statedb,
                 chain_config, config: Config = None):
        self.block_ctx = block_ctx
        self.tx_ctx = tx_ctx
        self.statedb = statedb
        self.chain_config = chain_config
        self.config = config or Config()
        self.rules = chain_config.rules(block_ctx.block_number, block_ctx.time)
        self.jump_table = jump_table_for_rules(self.rules)
        self.fast_table = fast_table_for_rules(self.rules)
        self.precompiles = active_precompiles(self.rules)
        self.interpreter = Interpreter(self)
        self.depth = 0
        self.call_gas_temp = 0
        self.abort = False

    def reset(self, tx_ctx: TxContext, statedb) -> None:
        self.tx_ctx = tx_ctx
        self.statedb = statedb

    # --- helpers ----------------------------------------------------------

    def _precompile(self, addr: bytes):
        return self.precompiles.get(addr)

    def _run_interpreter(self, contract: Contract, input_: bytes, read_only: bool):
        """Returns (ret, err). Gas state lives on the contract."""
        try:
            ret = self.interpreter.run(contract, input_, read_only)
            return ret, None
        except vmerrs.VMError as e:
            return vmerrs.revert_data(e), e
        except (RecursionError, MemoryError):
            raise
        except (IndexError, OverflowError, ValueError) as e:
            # defensive: interpreter bugs must not corrupt consensus — treat
            # as an invalid-opcode-class failure consuming all gas
            return b"", vmerrs.ErrInvalidOpcode

    # --- call family ------------------------------------------------------

    def call(self, caller: bytes, addr: bytes, input_: bytes, gas: int,
             value: int) -> Tuple[bytes, int, Optional[Exception]]:
        """EVM.Call (evm.go:229-305)."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", gas, vmerrs.ErrDepth
        if value != 0 and not self.block_ctx.can_transfer(self.statedb, caller, value):
            return b"", gas, vmerrs.ErrInsufficientBalance
        snapshot = self.statedb.snapshot()
        p = self._precompile(addr)
        if not self.statedb.exist(addr):
            if p is None and self.rules.is_eip158 and value == 0:
                return b"", gas, None
            self.statedb.create_account(addr)
        self.block_ctx.transfer(self.statedb, caller, addr, value)

        self.depth += 1
        try:
            if p is not None:
                ret, gas, err = self._run_precompile(p, caller, addr, input_, gas, False)
            else:
                code = self.statedb.get_code(addr)
                if len(code) == 0:
                    ret, err = b"", None
                else:
                    contract = Contract(caller, addr, value, gas)
                    contract.set_call_code(code, self.statedb.get_code_hash(addr))
                    ret, err = self._run_interpreter(contract, input_, False)
                    gas = contract.gas
        finally:
            self.depth -= 1

        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
        return ret, gas, err

    def call_code(self, caller: bytes, addr: bytes, input_: bytes, gas: int,
                  value: int) -> Tuple[bytes, int, Optional[Exception]]:
        """EVM.CallCode (evm.go:482-527): execute addr's code at caller."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", gas, vmerrs.ErrDepth
        if not self.block_ctx.can_transfer(self.statedb, caller, value):
            return b"", gas, vmerrs.ErrInsufficientBalance
        snapshot = self.statedb.snapshot()
        p = self._precompile(addr)
        self.depth += 1
        try:
            if p is not None:
                ret, gas, err = self._run_precompile(p, caller, addr, input_, gas, False)
            else:
                contract = Contract(caller, caller, value, gas)
                contract.set_call_code(
                    self.statedb.get_code(addr), self.statedb.get_code_hash(addr)
                )
                ret, err = self._run_interpreter(contract, input_, False)
                gas = contract.gas
        finally:
            self.depth -= 1
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
        return ret, gas, err

    def delegate_call(self, parent: Contract, addr: bytes, input_: bytes,
                      gas: int) -> Tuple[bytes, int, Optional[Exception]]:
        """EVM.DelegateCall (evm.go:529-568): parent's caller+value context."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", gas, vmerrs.ErrDepth
        snapshot = self.statedb.snapshot()
        p = self._precompile(addr)
        self.depth += 1
        try:
            if p is not None:
                ret, gas, err = self._run_precompile(
                    p, parent.caller_addr, addr, input_, gas, False
                )
            else:
                contract = Contract(parent.caller_addr, parent.address, parent.value, gas)
                contract.set_call_code(
                    self.statedb.get_code(addr), self.statedb.get_code_hash(addr)
                )
                ret, err = self._run_interpreter(contract, input_, False)
                gas = contract.gas
        finally:
            self.depth -= 1
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
        return ret, gas, err

    def static_call(self, caller: bytes, addr: bytes, input_: bytes,
                    gas: int) -> Tuple[bytes, int, Optional[Exception]]:
        """EVM.StaticCall (evm.go:570-621)."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", gas, vmerrs.ErrDepth
        snapshot = self.statedb.snapshot()
        # touch the callee balance so the journal matches geth's AddBalance(0)
        self.statedb.add_balance(addr, 0)
        p = self._precompile(addr)
        self.depth += 1
        try:
            if p is not None:
                ret, gas, err = self._run_precompile(p, caller, addr, input_, gas, True)
            else:
                contract = Contract(caller, addr, 0, gas)
                contract.set_call_code(
                    self.statedb.get_code(addr), self.statedb.get_code_hash(addr)
                )
                ret, err = self._run_interpreter(contract, input_, True)
                gas = contract.gas
        finally:
            self.depth -= 1
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
        return ret, gas, err

    def call_expert(self, caller: bytes, addr: bytes, input_: bytes, gas: int,
                    value: int, coin_id: bytes, value2: int
                    ) -> Tuple[bytes, int, Optional[Exception]]:
        """EVM.CallExpert (evm.go:411-480): CALL + multicoin transfer.
        Live only [AP1, AP2) via the CALLEX opcode."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", gas, vmerrs.ErrDepth
        if not self.block_ctx.can_transfer(self.statedb, caller, value):
            return b"", gas, vmerrs.ErrInsufficientBalance
        if value2 != 0 and not self.block_ctx.can_transfer_mc(
            self.statedb, caller, coin_id, value2
        ):
            return b"", gas, vmerrs.ErrInsufficientBalance
        snapshot = self.statedb.snapshot()
        p = self._precompile(addr)
        if not self.statedb.exist(addr):
            if p is None and self.rules.is_eip158 and value == 0 and value2 == 0:
                return b"", gas, None
            self.statedb.create_account(addr)
        self.block_ctx.transfer(self.statedb, caller, addr, value)
        if value2 != 0:
            self.block_ctx.transfer_multicoin(self.statedb, caller, addr, coin_id, value2)
        self.depth += 1
        try:
            if p is not None:
                ret, gas, err = self._run_precompile(p, caller, addr, input_, gas, False)
            else:
                code = self.statedb.get_code(addr)
                if len(code) == 0:
                    ret, err = b"", None
                else:
                    contract = Contract(caller, addr, value, gas)
                    contract.set_call_code(code, self.statedb.get_code_hash(addr))
                    ret, err = self._run_interpreter(contract, input_, False)
                    gas = contract.gas
        finally:
            self.depth -= 1
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
        return ret, gas, err

    def native_asset_call(self, caller: bytes, input_: bytes, gas: int,
                          gas_cost: int, read_only: bool
                          ) -> Tuple[bytes, int]:
        """EVM.NativeAssetCall (evm.go:688-740) — raises vmerrs on failure
        (precompile calling convention)."""
        if gas < gas_cost:
            raise vmerrs.ErrOutOfGas
        gas -= gas_cost
        if read_only:
            raise vmerrs.ErrExecutionReverted
        if len(input_) < 84:
            raise vmerrs.ErrExecutionReverted
        to = input_[:20]
        asset_id = input_[20:52]
        amount = int.from_bytes(input_[52:84], "big")
        call_data = input_[84:]

        if amount != 0 and not self.block_ctx.can_transfer_mc(
            self.statedb, caller, asset_id, amount
        ):
            raise vmerrs.ErrInsufficientBalance

        snapshot = self.statedb.snapshot()
        if not self.statedb.exist(to):
            if gas < G.CALL_NEW_ACCOUNT_GAS:
                raise vmerrs.ErrOutOfGas
            gas -= G.CALL_NEW_ACCOUNT_GAS
            self.statedb.create_account(to)

        self.depth += 1
        try:
            self.block_ctx.transfer_multicoin(self.statedb, caller, to, asset_id, amount)
            ret, gas, err = self.call(caller, to, call_data, gas, 0)
        finally:
            self.depth -= 1
        if err is not None:
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                gas = 0
            # re-raise in precompile convention with gas context attached
            err.remaining_gas = gas  # type: ignore[attr-defined]
            raise err
        return ret, gas

    def _run_precompile(self, p, caller, addr, input_, gas, read_only):
        try:
            ret, remaining = p.run(self, caller, addr, input_, gas, read_only)
            return ret, remaining, None
        except vmerrs.VMError as e:
            remaining = getattr(e, "remaining_gas", 0 if not vmerrs.is_revert(e) else gas)
            return vmerrs.revert_data(e), remaining, e

    # --- create -----------------------------------------------------------

    def create(self, caller: bytes, code: bytes, gas: int, value: int):
        """EVM.Create (evm.go:670): CREATE address = keccak(rlp(caller, nonce))."""
        from ..core.types import create_address

        addr = create_address(caller, self.statedb.get_nonce(caller))
        return self._create(caller, code, gas, value, addr)

    def create2(self, caller: bytes, code: bytes, gas: int, value: int, salt: bytes):
        """EVM.Create2 (evm.go:679): keccak(0xff ++ caller ++ salt ++ keccak(code))[12:]."""
        from ..core.types import create_address2

        addr = create_address2(caller, salt, keccak256(code))
        return self._create(caller, code, gas, value, addr)

    def _create(self, caller: bytes, code: bytes, gas: int, value: int,
                addr: bytes):
        """evm.go:623-668 create() body."""
        if self.depth > G.MAX_CALL_DEPTH:
            return b"", addr, gas, vmerrs.ErrDepth
        if not self.block_ctx.can_transfer(self.statedb, caller, value):
            return b"", addr, gas, vmerrs.ErrInsufficientBalance
        nonce = self.statedb.get_nonce(caller)
        if nonce + 1 > (1 << 64) - 1:
            return b"", addr, gas, vmerrs.ErrNonceUintOverflow
        self.statedb.set_nonce(caller, nonce + 1)
        # EIP-2929: created address becomes warm even on failure
        if self.rules.is_apricot_phase2:
            self.statedb.add_address_to_access_list(addr)
        # collision check
        contract_hash = self.statedb.get_code_hash(addr)
        if self.statedb.get_nonce(addr) != 0 or (
            contract_hash not in (b"", EMPTY_CODE_HASH) and self.statedb.exist(addr)
        ):
            return b"", addr, 0, vmerrs.ErrContractAddressCollision

        snapshot = self.statedb.snapshot()
        self.statedb.create_account(addr)
        if self.rules.is_eip158:
            self.statedb.set_nonce(addr, 1)
        self.block_ctx.transfer(self.statedb, caller, addr, value)

        contract = Contract(caller, addr, value, gas)
        contract.set_call_code(code, keccak256(code))

        self.depth += 1
        try:
            ret, err = self._run_interpreter(contract, b"", False)
        finally:
            self.depth -= 1

        if err is None and self.rules.is_eip158 and len(ret) > G.MAX_CODE_SIZE:
            err = vmerrs.ErrMaxCodeSizeExceeded
        if err is None and len(ret) >= 1 and ret[0] == 0xEF and self.rules.is_apricot_phase3:
            err = vmerrs.ErrInvalidCode
        if err is None:
            create_data_gas = len(ret) * G.CREATE_DATA_GAS
            if contract.use_gas(create_data_gas):
                self.statedb.set_code(addr, ret)
            else:
                err = vmerrs.ErrCodeStoreOutOfGas

        if err is not None and (self.rules.is_homestead or err is not vmerrs.ErrCodeStoreOutOfGas):
            self.statedb.revert_to_snapshot(snapshot)
            if not vmerrs.is_revert(err):
                contract.gas = 0
        return ret, addr, contract.gas, err
