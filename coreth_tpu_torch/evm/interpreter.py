"""EVM interpreter: stack, memory, jump tables, run loop.

Semantics of coreth core/vm/{interpreter,instructions,stack,memory,
gas_table,operations_acl,jump_table,eips,analysis}.go.

Fork lattice mirrors jump_table.go:64-137: Istanbul (EIP-1344/1884/2200)
→ ApricotPhase1 (refunds removed, eips.go:167-171) → ApricotPhase2
(EIP-2929 + multicoin opcodes disabled, eips.go:173-177) → ApricotPhase3
(EIP-3198 BASEFEE) → DUpgrade (EIP-3855 PUSH0, EIP-3860 initcode metering).

Values on the stack are Python ints in [0, 2^256); memory is a bytearray
grown in 32-byte words. Gas lives on the Contract, as in the reference.

Counterpart of coreth_tpu/evm/interpreter.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .. import vmerrs
from ..native import keccak256
from ..utils.deadline import check as deadline_check
from . import gas as G
from . import opcodes as OP

U256 = (1 << 256) - 1
SIGN_BIT = 1 << 255
STACK_LIMIT = 1024
MAX_UINT64 = (1 << 64) - 1

# the reference caps memory at the largest word-aligned uint64 size
# (common.go calcMemSize64 / memoryGasCost overflow guard)
MAX_MEM = 0x1FFFFFFFE0

# run-loop control signals. Execute functions return None to continue,
# SIG_JUMPED after setting interp.pc, or a (signal, data) pair for the
# terminating three. Integers compared by identity: one pointer test per
# step instead of string equality.
SIG_JUMPED = 1
SIG_STOP = 2
SIG_RETURN = 3
SIG_REVERT = 4

# fast dispatch loop default: pre-parsed instruction streams + 256-entry
# list jump table. CORETH_TPU_EVM_FASTLOOP=0 (or the evm-fastloop config
# knob) reverts to the legacy dict-dispatch loop; both are bit-identical
# in gas, refunds, tracer callbacks, and revert data.
FASTLOOP_DEFAULT = True


def fastloop_enabled(cfg_val: Optional[bool] = None) -> bool:
    """Resolve the loop choice: env override > per-EVM config > default."""
    env = os.environ.get("CORETH_TPU_EVM_FASTLOOP")
    if env is not None and env != "":
        return env.strip().lower() not in ("0", "false", "off", "no")
    if cfg_val is not None:
        return bool(cfg_val)
    return FASTLOOP_DEFAULT


def _signed(x: int) -> int:
    return x - (1 << 256) if x & SIGN_BIT else x


def _unsigned(x: int) -> int:
    return x & U256


# --- stack ----------------------------------------------------------------


class Stack:
    __slots__ = ("data",)

    def __init__(self):
        self.data: List[int] = []

    def push(self, v: int) -> None:
        self.data.append(v)

    def pop(self) -> int:
        return self.data.pop()

    def peek(self) -> int:
        return self.data[-1]

    def back(self, n: int) -> int:
        """n-th item from the top (back(0) == peek)."""
        return self.data[-1 - n]

    def set_top(self, v: int) -> None:
        self.data[-1] = v

    def dup(self, n: int) -> None:
        self.data.append(self.data[-n])

    def swap(self, n: int) -> None:
        self.data[-1], self.data[-1 - n] = self.data[-1 - n], self.data[-1]

    def __len__(self) -> int:
        return len(self.data)


# --- memory ---------------------------------------------------------------


class Memory:
    __slots__ = ("data", "last_gas_cost")

    def __init__(self):
        self.data = bytearray()
        self.last_gas_cost = 0

    def __len__(self) -> int:
        return len(self.data)

    def resize(self, size: int) -> None:
        if size > len(self.data):
            self.data.extend(b"\x00" * (size - len(self.data)))

    def get(self, offset: int, size: int) -> bytes:
        if size == 0:
            return b""
        return bytes(self.data[offset : offset + size])

    def set(self, offset: int, size: int, value: bytes) -> None:
        if size == 0:
            return
        self.data[offset : offset + size] = value[:size].ljust(size, b"\x00")

    def set32(self, offset: int, value: int) -> None:
        self.data[offset : offset + 32] = value.to_bytes(32, "big")


def memory_gas_cost(mem: Memory, new_size: int) -> int:
    """Quadratic memory expansion gas (gas_table.go memoryGasCost)."""
    if new_size == 0:
        return 0
    if new_size > MAX_MEM:
        raise vmerrs.ErrGasUintOverflow
    new_words = (new_size + 31) // 32
    new_total = G.MEMORY_GAS * new_words + new_words * new_words // G.QUAD_COEFF_DIV
    if new_total > mem.last_gas_cost:
        fee = new_total - mem.last_gas_cost
        return fee
    return 0


def _charge_memory(mem: Memory, new_size: int) -> int:
    """Returns the expansion fee and records the charge (applied by caller)."""
    fee = memory_gas_cost(mem, new_size)
    return fee


# --- contract -------------------------------------------------------------

_analysis_cache: Dict[bytes, frozenset] = {}


def code_jumpdests(code: bytes, code_hash: Optional[bytes] = None) -> frozenset:
    """Valid JUMPDEST positions, skipping PUSH data (analysis.go)."""
    key = code_hash
    if key is not None:
        cached = _analysis_cache.get(key)
        if cached is not None:
            return cached
    dests = set()
    i, n = 0, len(code)
    while i < n:
        op = code[i]
        if op == OP.JUMPDEST:
            dests.add(i)
            i += 1
        elif OP.PUSH1 <= op <= OP.PUSH32:
            i += op - OP.PUSH1 + 2
        else:
            i += 1
    fs = frozenset(dests)
    if key is not None and len(_analysis_cache) < 4096:
        _analysis_cache[key] = fs
    return fs


class Contract:
    """Execution frame: code + gas + value context (core/vm/contract.go)."""

    __slots__ = (
        "caller_addr", "address", "code", "code_hash", "input", "gas", "value",
        "_jumpdests",
    )

    def __init__(self, caller_addr: bytes, address: bytes, value: int, gas: int):
        self.caller_addr = caller_addr
        self.address = address
        self.value = value
        self.gas = gas
        self.code = b""
        self.code_hash: Optional[bytes] = None
        self.input = b""
        self._jumpdests: Optional[frozenset] = None

    def set_call_code(self, code: bytes, code_hash: Optional[bytes]) -> None:
        self.code = code
        self.code_hash = code_hash
        self._jumpdests = None

    def valid_jumpdest(self, dest: int) -> bool:
        if dest >= len(self.code) or dest > MAX_UINT64:
            return False
        if self.code[dest] != OP.JUMPDEST:
            return False
        if self._jumpdests is None:
            self._jumpdests = code_jumpdests(self.code, self.code_hash)
        return dest in self._jumpdests

    def use_gas(self, amount: int) -> bool:
        if self.gas < amount:
            return False
        self.gas -= amount
        return True


# --- operation table ------------------------------------------------------

ExecFn = Callable[["Interpreter", "Scope"], Optional[Tuple[str, bytes]]]
GasFn = Callable[["Interpreter", Contract, Stack, Memory, int], int]
MemFn = Callable[[Stack], int]


@dataclass
class Operation:
    execute: ExecFn
    constant_gas: int = 0
    min_stack: int = 0
    max_stack: int = STACK_LIMIT
    dynamic_gas: Optional[GasFn] = None
    memory_size: Optional[MemFn] = None
    writes: bool = False  # read-only (STATICCALL) protection


def _op(pops: int, pushes: int, **kw) -> dict:
    return dict(min_stack=pops, max_stack=STACK_LIMIT + pops - pushes, **kw)


class Scope:
    __slots__ = ("stack", "memory", "contract")

    def __init__(self, stack: Stack, memory: Memory, contract: Contract):
        self.stack = stack
        self.memory = memory
        self.contract = contract


# --- memory size helpers --------------------------------------------------


def _mem_size(off: int, length: int) -> int:
    """calcMemSize64: offset+len with uint64 overflow → error."""
    if length == 0:
        return 0
    if off > MAX_UINT64 or length > MAX_UINT64 or off + length > MAX_UINT64:
        raise vmerrs.ErrGasUintOverflow
    return off + length


def mem_keccak(st: Stack) -> int:
    return _mem_size(st.back(0), st.back(1))


def mem_calldatacopy(st: Stack) -> int:
    return _mem_size(st.back(0), st.back(2))


def mem_extcodecopy(st: Stack) -> int:
    return _mem_size(st.back(1), st.back(3))


def mem_mload(st: Stack) -> int:
    return _mem_size(st.back(0), 32)


def mem_mstore8(st: Stack) -> int:
    return _mem_size(st.back(0), 1)


def mem_create(st: Stack) -> int:
    return _mem_size(st.back(1), st.back(2))


def mem_call(st: Stack) -> int:
    return max(_mem_size(st.back(5), st.back(6)), _mem_size(st.back(3), st.back(4)))


def mem_delegatecall(st: Stack) -> int:
    return max(_mem_size(st.back(4), st.back(5)), _mem_size(st.back(2), st.back(3)))


def mem_callexpert(st: Stack) -> int:
    return max(_mem_size(st.back(7), st.back(8)), _mem_size(st.back(5), st.back(6)))


def mem_return(st: Stack) -> int:
    return _mem_size(st.back(0), st.back(1))


def mem_log(st: Stack) -> int:
    return _mem_size(st.back(0), st.back(1))


# --- dynamic gas ----------------------------------------------------------


def gas_mem_only(interp, contract, st, mem, msize) -> int:
    return _charge_memory(mem, msize)


def gas_keccak256(interp, contract, st, mem, msize) -> int:
    words = (st.back(1) + 31) // 32
    if st.back(1) > MAX_UINT64:
        raise vmerrs.ErrGasUintOverflow
    return _charge_memory(mem, msize) + G.KECCAK256_WORD_GAS * words


def _gas_copy(length_slot: int):
    def fn(interp, contract, st, mem, msize) -> int:
        length = st.back(length_slot)
        if length > MAX_UINT64:
            raise vmerrs.ErrGasUintOverflow
        return _charge_memory(mem, msize) + G.COPY_GAS * ((length + 31) // 32)

    return fn


gas_calldatacopy = _gas_copy(2)
gas_extcodecopy_base = _gas_copy(3)


def gas_exp(interp, contract, st, mem, msize) -> int:
    exp = st.back(1)
    byte_len = (exp.bit_length() + 7) // 8
    return G.GAS_SLOW + G.EXP_BYTE_GAS_EIP158 * byte_len


def make_gas_log(n_topics: int) -> GasFn:
    def fn(interp, contract, st, mem, msize) -> int:
        size = st.back(1)
        if size > MAX_UINT64:
            raise vmerrs.ErrGasUintOverflow
        return (
            _charge_memory(mem, msize)
            + G.LOG_GAS
            + G.LOG_TOPIC_GAS * n_topics
            + G.LOG_DATA_GAS * size
        )

    return fn


def gas_sstore_eip2200(interp, contract, st, mem, msize) -> int:
    """Istanbul net-metered SSTORE with refunds (gas_table.go:182-232)."""
    if contract.gas <= G.SSTORE_SENTRY_EIP2200:
        raise vmerrs.ErrOutOfGas
    db = interp.evm.statedb
    addr = contract.address
    x, y = st.back(0), st.back(1)
    key = x.to_bytes(32, "big")
    value = y.to_bytes(32, "big")
    current = db.get_state(addr, key)
    if current == value:
        return G.SLOAD_GAS_EIP2200
    original = db.get_committed_state(addr, key)
    zero = b"\x00" * 32
    if original == current:
        if original == zero:
            return G.SSTORE_SET_GAS
        if value == zero:
            db.add_refund(G.SSTORE_CLEARS_SCHEDULE)
        return G.SSTORE_RESET_GAS
    if original != zero:
        if current == zero:
            db.sub_refund(G.SSTORE_CLEARS_SCHEDULE)
        elif value == zero:
            db.add_refund(G.SSTORE_CLEARS_SCHEDULE)
    if original == value:
        if original == zero:
            db.add_refund(G.SSTORE_SET_GAS - G.SLOAD_GAS_EIP2200)
        else:
            db.add_refund(G.SSTORE_RESET_GAS - G.SLOAD_GAS_EIP2200)
    return G.SLOAD_GAS_EIP2200


def gas_sstore_ap1(interp, contract, st, mem, msize) -> int:
    """AP1: EIP-2200 shape with ALL refund logic removed (gas_table.go:243)."""
    if contract.gas <= G.SSTORE_SENTRY_EIP2200:
        raise vmerrs.ErrOutOfGas
    db = interp.evm.statedb
    addr = contract.address
    key = st.back(0).to_bytes(32, "big")
    value = st.back(1).to_bytes(32, "big")
    current = db.get_state(addr, key)
    if current == value:
        return G.SLOAD_GAS_EIP2200
    original = db.get_committed_state(addr, key)
    if original == current:
        if original == b"\x00" * 32:
            return G.SSTORE_SET_GAS
        return G.SSTORE_RESET_GAS
    return G.SLOAD_GAS_EIP2200


def gas_sstore_eip2929(interp, contract, st, mem, msize) -> int:
    """Berlin/AP2 SSTORE: access-list pricing, no refunds in coreth
    (operations_acl.go:50-94)."""
    if contract.gas <= G.SSTORE_SENTRY_EIP2200:
        raise vmerrs.ErrOutOfGas
    db = interp.evm.statedb
    addr = contract.address
    key = st.back(0).to_bytes(32, "big")
    value = st.back(1).to_bytes(32, "big")
    cost = 0
    _, slot_present = db.slot_in_access_list(addr, key)
    if not slot_present:
        cost = G.COLD_SLOAD_COST
        db.add_slot_to_access_list(addr, key)
    current = db.get_state(addr, key)
    if current == value:
        return cost + G.WARM_STORAGE_READ_COST
    original = db.get_committed_state(addr, key)
    if original == current:
        if original == b"\x00" * 32:
            return cost + G.SSTORE_SET_GAS
        return cost + (G.SSTORE_RESET_GAS - G.COLD_SLOAD_COST)
    return cost + G.WARM_STORAGE_READ_COST


def gas_sload_eip2929(interp, contract, st, mem, msize) -> int:
    db = interp.evm.statedb
    key = st.back(0).to_bytes(32, "big")
    _, slot_present = db.slot_in_access_list(contract.address, key)
    if slot_present:
        return G.WARM_STORAGE_READ_COST
    db.add_slot_to_access_list(contract.address, key)
    return G.COLD_SLOAD_COST


def gas_account_check_eip2929(interp, contract, st, mem, msize) -> int:
    """BALANCE/EXTCODESIZE/EXTCODEHASH under EIP-2929."""
    db = interp.evm.statedb
    addr = st.back(0).to_bytes(32, "big")[12:]
    if db.address_in_access_list(addr):
        return 0
    db.add_address_to_access_list(addr)
    return G.COLD_ACCOUNT_ACCESS_COST - G.WARM_STORAGE_READ_COST


def gas_extcodecopy_eip2929(interp, contract, st, mem, msize) -> int:
    base = gas_extcodecopy_base(interp, contract, st, mem, msize)
    db = interp.evm.statedb
    addr = st.back(0).to_bytes(32, "big")[12:]
    if not db.address_in_access_list(addr):
        db.add_address_to_access_list(addr)
        base += G.COLD_ACCOUNT_ACCESS_COST - G.WARM_STORAGE_READ_COST
    return base


def _call_gas_eip150(is_eip150: bool, available: int, base: int, requested: int) -> int:
    """callGas (gas.go:37): 63/64 forwarding cap post-EIP-150."""
    if is_eip150:
        avail = available - base
        cap = avail - avail // 64
        if requested > cap or requested > MAX_UINT64:
            return cap
    if requested > MAX_UINT64:
        raise vmerrs.ErrGasUintOverflow
    return requested


def gas_call(interp, contract, st, mem, msize) -> int:
    """gasCall (gas_table.go:410-444)."""
    evm = interp.evm
    gas = 0
    transfers_value = st.back(2) != 0
    addr = st.back(1).to_bytes(32, "big")[12:]
    if evm.rules.is_eip158:
        if transfers_value and evm.statedb.empty(addr):
            gas += G.CALL_NEW_ACCOUNT_GAS
    elif not evm.statedb.exist(addr):
        gas += G.CALL_NEW_ACCOUNT_GAS
    if transfers_value:
        gas += G.CALL_VALUE_TRANSFER_GAS
    gas += _charge_memory(mem, msize)
    evm.call_gas_temp = _call_gas_eip150(
        evm.rules.is_eip150, contract.gas, gas, st.back(0)
    )
    return gas + evm.call_gas_temp


def gas_callcode(interp, contract, st, mem, msize) -> int:
    evm = interp.evm
    gas = _charge_memory(mem, msize)
    if st.back(2) != 0:
        gas += G.CALL_VALUE_TRANSFER_GAS
    evm.call_gas_temp = _call_gas_eip150(
        evm.rules.is_eip150, contract.gas, gas, st.back(0)
    )
    return gas + evm.call_gas_temp


def gas_delegate_or_static(interp, contract, st, mem, msize) -> int:
    evm = interp.evm
    gas = _charge_memory(mem, msize)
    evm.call_gas_temp = _call_gas_eip150(
        evm.rules.is_eip150, contract.gas, gas, st.back(0)
    )
    return gas + evm.call_gas_temp


def gas_call_expert_ap1(interp, contract, st, mem, msize) -> int:
    """gasCallExpertAP1 (gas_table.go:445): CALL pricing + multicoin value."""
    evm = interp.evm
    gas = 0
    transfers_value = st.back(2) != 0
    mc_transfers_value = st.back(4) != 0
    addr = st.back(1).to_bytes(32, "big")[12:]
    if evm.rules.is_eip158:
        if (transfers_value or mc_transfers_value) and evm.statedb.empty(addr):
            gas += G.CALL_NEW_ACCOUNT_GAS
    elif not evm.statedb.exist(addr):
        gas += G.CALL_NEW_ACCOUNT_GAS
    if transfers_value:
        gas += G.CALL_VALUE_TRANSFER_GAS
    if mc_transfers_value:
        gas += G.CALL_VALUE_TRANSFER_GAS
    gas += _charge_memory(mem, msize)
    evm.call_gas_temp = _call_gas_eip150(
        evm.rules.is_eip150, contract.gas, gas, st.back(0)
    )
    return gas + evm.call_gas_temp


def make_call_variant_eip2929(old_calculator: GasFn) -> GasFn:
    """makeCallVariantGasCallEIP2929 (operations_acl.go:135-165): cold cost is
    burned BEFORE the 63/64 computation, then credited back into the charge."""

    def fn(interp, contract, st, mem, msize) -> int:
        db = interp.evm.statedb
        addr = st.back(1).to_bytes(32, "big")[12:]
        warm = db.address_in_access_list(addr)
        cold_cost = G.COLD_ACCOUNT_ACCESS_COST - G.WARM_STORAGE_READ_COST
        if not warm:
            db.add_address_to_access_list(addr)
            if not contract.use_gas(cold_cost):
                raise vmerrs.ErrOutOfGas
        gas = old_calculator(interp, contract, st, mem, msize)
        if warm:
            return gas
        contract.gas += cold_cost
        return gas + cold_cost

    return fn


def gas_create(interp, contract, st, mem, msize) -> int:
    return _charge_memory(mem, msize)


def gas_create2(interp, contract, st, mem, msize) -> int:
    size = st.back(2)
    if size > MAX_UINT64:
        raise vmerrs.ErrGasUintOverflow
    return _charge_memory(mem, msize) + G.KECCAK256_WORD_GAS * ((size + 31) // 32)


def gas_create_eip3860(interp, contract, st, mem, msize) -> int:
    size = st.back(2)
    if size > G.MAX_INIT_CODE_SIZE:
        raise vmerrs.ErrMaxInitCodeSizeExceeded
    return _charge_memory(mem, msize) + G.INIT_CODE_WORD_GAS * ((size + 31) // 32)


def gas_create2_eip3860(interp, contract, st, mem, msize) -> int:
    size = st.back(2)
    if size > G.MAX_INIT_CODE_SIZE:
        raise vmerrs.ErrMaxInitCodeSizeExceeded
    words = (size + 31) // 32
    return _charge_memory(mem, msize) + (G.KECCAK256_WORD_GAS + G.INIT_CODE_WORD_GAS) * words


def gas_selfdestruct_eip150(interp, contract, st, mem, msize) -> int:
    """Pre-AP1 (istanbul) selfdestruct: EIP-150 pricing + refund."""
    evm = interp.evm
    gas = G.SELFDESTRUCT_GAS_EIP150
    addr = st.back(0).to_bytes(32, "big")[12:]
    if evm.rules.is_eip158:
        if evm.statedb.empty(addr) and evm.statedb.get_balance(contract.address) != 0:
            gas += G.CREATE_BY_SELFDESTRUCT_GAS
    elif not evm.statedb.exist(addr):
        gas += G.CREATE_BY_SELFDESTRUCT_GAS
    if not evm.statedb.has_suicided(contract.address):
        evm.statedb.add_refund(G.SELFDESTRUCT_REFUND)
    return gas


def gas_selfdestruct_ap1(interp, contract, st, mem, msize) -> int:
    """AP1: same pricing, refund removed (eips.go gasSelfdestructAP1)."""
    evm = interp.evm
    gas = G.SELFDESTRUCT_GAS_EIP150
    addr = st.back(0).to_bytes(32, "big")[12:]
    if evm.rules.is_eip158:
        if evm.statedb.empty(addr) and evm.statedb.get_balance(contract.address) != 0:
            gas += G.CREATE_BY_SELFDESTRUCT_GAS
    elif not evm.statedb.exist(addr):
        gas += G.CREATE_BY_SELFDESTRUCT_GAS
    return gas


def gas_selfdestruct_eip2929(interp, contract, st, mem, msize) -> int:
    """AP2: access-list pricing, no refund (operations_acl.go:199-215)."""
    evm = interp.evm
    gas = 0
    addr = st.back(0).to_bytes(32, "big")[12:]
    if not evm.statedb.address_in_access_list(addr):
        evm.statedb.add_address_to_access_list(addr)
        gas = G.COLD_ACCOUNT_ACCESS_COST
    if evm.statedb.empty(addr) and evm.statedb.get_balance(contract.address) != 0:
        gas += G.CREATE_BY_SELFDESTRUCT_GAS
    return gas


# --- execute functions ----------------------------------------------------
# Each returns None to continue, SIG_JUMPED (pc already set), or a
# (signal, data) tuple: (SIG_STOP, b"") / (SIG_RETURN, data) /
# (SIG_REVERT, data)


def op_stop(interp, scope):
    return (SIG_STOP, b"")


def op_add(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top((x + st.peek()) & U256)


def op_mul(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top((x * st.peek()) & U256)


def op_sub(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top((x - st.peek()) & U256)


def op_div(interp, scope):
    st = scope.stack
    x = st.pop()
    y = st.peek()
    st.set_top(x // y if y else 0)


def op_sdiv(interp, scope):
    st = scope.stack
    x = _signed(st.pop())
    y = _signed(st.peek())
    if y == 0:
        st.set_top(0)
    else:
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        st.set_top(_unsigned(q))


def op_mod(interp, scope):
    st = scope.stack
    x = st.pop()
    y = st.peek()
    st.set_top(x % y if y else 0)


def op_smod(interp, scope):
    st = scope.stack
    x = _signed(st.pop())
    y = _signed(st.peek())
    if y == 0:
        st.set_top(0)
    else:
        r = abs(x) % abs(y)
        if x < 0:
            r = -r
        st.set_top(_unsigned(r))


def op_addmod(interp, scope):
    st = scope.stack
    x = st.pop()
    y = st.pop()
    z = st.peek()
    st.set_top((x + y) % z if z else 0)


def op_mulmod(interp, scope):
    st = scope.stack
    x = st.pop()
    y = st.pop()
    z = st.peek()
    st.set_top((x * y) % z if z else 0)


def op_exp(interp, scope):
    st = scope.stack
    base = st.pop()
    st.set_top(pow(base, st.peek(), 1 << 256))


def op_signextend(interp, scope):
    st = scope.stack
    back = st.pop()
    num = st.peek()
    if back < 31:
        bit = back * 8 + 7
        mask = (1 << (bit + 1)) - 1
        if num & (1 << bit):
            st.set_top((num | ~mask) & U256)
        else:
            st.set_top(num & mask)


def op_lt(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(1 if x < st.peek() else 0)


def op_gt(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(1 if x > st.peek() else 0)


def op_slt(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(1 if _signed(x) < _signed(st.peek()) else 0)


def op_sgt(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(1 if _signed(x) > _signed(st.peek()) else 0)


def op_eq(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(1 if x == st.peek() else 0)


def op_iszero(interp, scope):
    st = scope.stack
    st.set_top(1 if st.peek() == 0 else 0)


def op_and(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(x & st.peek())


def op_or(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(x | st.peek())


def op_xor(interp, scope):
    st = scope.stack
    x = st.pop()
    st.set_top(x ^ st.peek())


def op_not(interp, scope):
    st = scope.stack
    st.set_top(~st.peek() & U256)


def op_byte(interp, scope):
    st = scope.stack
    i = st.pop()
    val = st.peek()
    if i >= 32:
        st.set_top(0)
    else:
        st.set_top((val >> (8 * (31 - i))) & 0xFF)


def op_shl(interp, scope):
    st = scope.stack
    shift = st.pop()
    st.set_top((st.peek() << shift) & U256 if shift < 256 else 0)


def op_shr(interp, scope):
    st = scope.stack
    shift = st.pop()
    st.set_top(st.peek() >> shift if shift < 256 else 0)


def op_sar(interp, scope):
    st = scope.stack
    shift = st.pop()
    v = _signed(st.peek())
    if shift >= 256:
        st.set_top(U256 if v < 0 else 0)
    else:
        st.set_top(_unsigned(v >> shift))


def op_keccak256(interp, scope):
    st = scope.stack
    off = st.pop()
    size = st.peek()
    data = scope.memory.get(off, size)
    h = keccak256(data)
    if interp.evm.config.enable_preimage_recording:
        interp.evm.statedb.add_preimage(h, data)
    st.set_top(int.from_bytes(h, "big"))


def op_address(interp, scope):
    scope.stack.push(int.from_bytes(scope.contract.address, "big"))


def op_balance(interp, scope):
    st = scope.stack
    addr = st.peek().to_bytes(32, "big")[12:]
    st.set_top(interp.evm.statedb.get_balance(addr))


def op_balance_multicoin(interp, scope):
    """opBalanceMultiCoin (instructions.go:279) — live [genesis, AP2)."""
    st = scope.stack
    addr = st.pop().to_bytes(32, "big")[12:]
    cid = st.pop().to_bytes(32, "big")
    bal = interp.evm.statedb.get_balance_multicoin(addr, cid)
    if bal >= 1 << 256:
        raise vmerrs.VMError("balance overflow")
    st.push(bal)


def op_origin(interp, scope):
    scope.stack.push(int.from_bytes(interp.evm.tx_ctx.origin, "big"))


def op_caller(interp, scope):
    scope.stack.push(int.from_bytes(scope.contract.caller_addr, "big"))


def op_callvalue(interp, scope):
    scope.stack.push(scope.contract.value)


def op_calldataload(interp, scope):
    st = scope.stack
    off = st.peek()
    data = scope.contract.input
    if off >= len(data):
        st.set_top(0)
    else:
        chunk = data[off : off + 32]
        st.set_top(int.from_bytes(chunk.ljust(32, b"\x00"), "big"))


def op_calldatasize(interp, scope):
    scope.stack.push(len(scope.contract.input))


def _copy_zero_padded(src: bytes, off: int, size: int) -> bytes:
    if off > len(src):
        off = len(src)
    chunk = src[off : off + size]
    return chunk.ljust(size, b"\x00")


def op_calldatacopy(interp, scope):
    st = scope.stack
    mem_off = st.pop()
    data_off = st.pop()
    size = st.pop()
    scope.memory.set(mem_off, size, _copy_zero_padded(scope.contract.input, min(data_off, MAX_UINT64), size))


def op_codesize(interp, scope):
    scope.stack.push(len(scope.contract.code))


def op_codecopy(interp, scope):
    st = scope.stack
    mem_off = st.pop()
    code_off = st.pop()
    size = st.pop()
    scope.memory.set(mem_off, size, _copy_zero_padded(scope.contract.code, min(code_off, MAX_UINT64), size))


def op_gasprice(interp, scope):
    scope.stack.push(interp.evm.tx_ctx.gas_price)


def op_extcodesize(interp, scope):
    st = scope.stack
    addr = st.peek().to_bytes(32, "big")[12:]
    st.set_top(interp.evm.statedb.get_code_size(addr))


def op_extcodecopy(interp, scope):
    st = scope.stack
    addr = st.pop().to_bytes(32, "big")[12:]
    mem_off = st.pop()
    code_off = st.pop()
    size = st.pop()
    code = interp.evm.statedb.get_code(addr)
    scope.memory.set(mem_off, size, _copy_zero_padded(code, min(code_off, MAX_UINT64), size))


def op_returndatasize(interp, scope):
    scope.stack.push(len(interp.return_data))


def op_returndatacopy(interp, scope):
    st = scope.stack
    mem_off = st.pop()
    data_off = st.pop()
    size = st.pop()
    if data_off + size > len(interp.return_data):
        raise vmerrs.ErrReturnDataOutOfBounds
    scope.memory.set(mem_off, size, interp.return_data[data_off : data_off + size])


def op_extcodehash(interp, scope):
    st = scope.stack
    addr = st.peek().to_bytes(32, "big")[12:]
    db = interp.evm.statedb
    if db.empty(addr):
        st.set_top(0)
    else:
        st.set_top(int.from_bytes(db.get_code_hash(addr), "big"))


def op_blockhash(interp, scope):
    st = scope.stack
    num = st.peek()
    ctx = interp.evm.block_ctx
    cur = ctx.block_number
    if num < cur and num >= max(0, cur - 256):
        h = ctx.get_hash(num)
        st.set_top(int.from_bytes(h, "big") if h else 0)
    else:
        st.set_top(0)


def op_coinbase(interp, scope):
    scope.stack.push(int.from_bytes(interp.evm.block_ctx.coinbase, "big"))


def op_timestamp(interp, scope):
    scope.stack.push(interp.evm.block_ctx.time)


def op_number(interp, scope):
    scope.stack.push(interp.evm.block_ctx.block_number)


def op_difficulty(interp, scope):
    scope.stack.push(interp.evm.block_ctx.difficulty)


def op_gaslimit(interp, scope):
    scope.stack.push(interp.evm.block_ctx.gas_limit)


def op_chainid(interp, scope):
    scope.stack.push(interp.evm.rules.chain_id)


def op_selfbalance(interp, scope):
    scope.stack.push(interp.evm.statedb.get_balance(scope.contract.address))


def op_basefee(interp, scope):
    scope.stack.push(interp.evm.block_ctx.base_fee or 0)


def op_pop(interp, scope):
    scope.stack.pop()


def op_mload(interp, scope):
    st = scope.stack
    off = st.peek()
    st.set_top(int.from_bytes(scope.memory.get(off, 32), "big"))


def op_mstore(interp, scope):
    st = scope.stack
    off = st.pop()
    val = st.pop()
    scope.memory.set32(off, val)


def op_mstore8(interp, scope):
    st = scope.stack
    off = st.pop()
    val = st.pop()
    scope.memory.data[off] = val & 0xFF


def op_sload(interp, scope):
    st = scope.stack
    key = st.peek().to_bytes(32, "big")
    val = interp.evm.statedb.get_state(scope.contract.address, key)
    st.set_top(int.from_bytes(val, "big"))


def op_sstore(interp, scope):
    st = scope.stack
    key = st.pop().to_bytes(32, "big")
    val = st.pop().to_bytes(32, "big")
    interp.evm.statedb.set_state(scope.contract.address, key, val)


def op_jump(interp, scope):
    dest = scope.stack.pop()
    if not scope.contract.valid_jumpdest(dest):
        raise vmerrs.ErrInvalidJump
    interp.pc = dest
    return SIG_JUMPED


def op_jumpi(interp, scope):
    st = scope.stack
    dest = st.pop()
    cond = st.pop()
    if cond != 0:
        if not scope.contract.valid_jumpdest(dest):
            raise vmerrs.ErrInvalidJump
        interp.pc = dest
        return SIG_JUMPED


def op_pc(interp, scope):
    scope.stack.push(interp.pc)


def op_msize(interp, scope):
    scope.stack.push(len(scope.memory))


def op_gas(interp, scope):
    scope.stack.push(scope.contract.gas)


def op_jumpdest(interp, scope):
    pass


def op_push0(interp, scope):
    scope.stack.push(0)


def make_push(size: int) -> ExecFn:
    def fn(interp, scope):
        code = scope.contract.code
        start = interp.pc + 1
        chunk = code[start : start + size]
        scope.stack.push(int.from_bytes(chunk.ljust(size, b"\x00"), "big"))
        interp.pc += size

    return fn


def make_dup(n: int) -> ExecFn:
    def fn(interp, scope):
        scope.stack.dup(n)

    return fn


def make_swap(n: int) -> ExecFn:
    def fn(interp, scope):
        scope.stack.swap(n)

    return fn


def make_log(n_topics: int) -> ExecFn:
    def fn(interp, scope):
        from ..state.log import Log

        st = scope.stack
        off = st.pop()
        size = st.pop()
        topics = [st.pop().to_bytes(32, "big") for _ in range(n_topics)]
        data = scope.memory.get(off, size)
        interp.evm.statedb.add_log(
            Log(scope.contract.address, topics, data)
        )

    return fn


def op_create(interp, scope):
    st = scope.stack
    value = st.pop()
    offset = st.pop()
    size = st.pop()
    evm = interp.evm
    input_ = scope.memory.get(offset, size)
    gas = scope.contract.gas
    if evm.rules.is_eip150:
        gas -= gas // 64
    scope.contract.use_gas(gas)
    ret, addr, return_gas, err = evm.create(scope.contract.address, input_, gas, value)
    if err is None:
        st.push(int.from_bytes(addr, "big"))
    else:
        st.push(0)
    scope.contract.gas += return_gas
    if vmerrs.is_revert(err):
        interp.return_data = ret
    else:
        interp.return_data = b""


def op_create2(interp, scope):
    st = scope.stack
    endowment = st.pop()
    offset = st.pop()
    size = st.pop()
    salt = st.pop()
    evm = interp.evm
    input_ = scope.memory.get(offset, size)
    gas = scope.contract.gas
    gas -= gas // 64  # CREATE2 is post-EIP-150 everywhere
    scope.contract.use_gas(gas)
    ret, addr, return_gas, err = evm.create2(
        scope.contract.address, input_, gas, endowment, salt.to_bytes(32, "big")
    )
    if err is None:
        st.push(int.from_bytes(addr, "big"))
    else:
        st.push(0)
    scope.contract.gas += return_gas
    if vmerrs.is_revert(err):
        interp.return_data = ret
    else:
        interp.return_data = b""


def _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size):
    st = scope.stack
    st.push(0 if err is not None else 1)
    if err is None or vmerrs.is_revert(err):
        scope.memory.set(ret_off, ret_size, ret)
    scope.contract.gas += return_gas
    interp.return_data = ret


def op_call(interp, scope):
    st = scope.stack
    st.pop()  # gas — actual forwarded gas is in evm.call_gas_temp
    addr = st.pop().to_bytes(32, "big")[12:]
    value = st.pop()
    in_off = st.pop()
    in_size = st.pop()
    ret_off = st.pop()
    ret_size = st.pop()
    evm = interp.evm
    gas = evm.call_gas_temp
    if interp.read_only and value != 0:
        raise vmerrs.ErrWriteProtection
    args = scope.memory.get(in_off, in_size)
    if value != 0:
        gas += G.CALL_STIPEND
    ret, return_gas, err = evm.call(scope.contract.address, addr, args, gas, value)
    _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size)


def op_callcode(interp, scope):
    st = scope.stack
    st.pop()
    addr = st.pop().to_bytes(32, "big")[12:]
    value = st.pop()
    in_off = st.pop()
    in_size = st.pop()
    ret_off = st.pop()
    ret_size = st.pop()
    evm = interp.evm
    gas = evm.call_gas_temp
    args = scope.memory.get(in_off, in_size)
    if value != 0:
        gas += G.CALL_STIPEND
    ret, return_gas, err = evm.call_code(scope.contract.address, addr, args, gas, value)
    _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size)


def op_delegatecall(interp, scope):
    st = scope.stack
    st.pop()
    addr = st.pop().to_bytes(32, "big")[12:]
    in_off = st.pop()
    in_size = st.pop()
    ret_off = st.pop()
    ret_size = st.pop()
    evm = interp.evm
    args = scope.memory.get(in_off, in_size)
    ret, return_gas, err = evm.delegate_call(
        scope.contract, addr, args, evm.call_gas_temp
    )
    _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size)


def op_staticcall(interp, scope):
    st = scope.stack
    st.pop()
    addr = st.pop().to_bytes(32, "big")[12:]
    in_off = st.pop()
    in_size = st.pop()
    ret_off = st.pop()
    ret_size = st.pop()
    evm = interp.evm
    args = scope.memory.get(in_off, in_size)
    ret, return_gas, err = evm.static_call(
        scope.contract.address, addr, args, evm.call_gas_temp
    )
    _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size)


def op_call_expert(interp, scope):
    """opCallExpert (instructions.go:720): CALL + multicoin transfer."""
    st = scope.stack
    st.pop()
    addr = st.pop().to_bytes(32, "big")[12:]
    value = st.pop()
    cid = st.pop().to_bytes(32, "big")
    value2 = st.pop()
    in_off = st.pop()
    in_size = st.pop()
    ret_off = st.pop()
    ret_size = st.pop()
    evm = interp.evm
    gas = evm.call_gas_temp
    if interp.read_only and value != 0:
        raise vmerrs.ErrWriteProtection
    args = scope.memory.get(in_off, in_size)
    if value != 0:
        gas += G.CALL_STIPEND
    ret, return_gas, err = evm.call_expert(
        scope.contract.address, addr, args, gas, value, cid, value2
    )
    _finish_call(interp, scope, ret, return_gas, err, ret_off, ret_size)


def op_return(interp, scope):
    st = scope.stack
    off = st.pop()
    size = st.pop()
    return (SIG_RETURN, scope.memory.get(off, size))


def op_revert(interp, scope):
    st = scope.stack
    off = st.pop()
    size = st.pop()
    return (SIG_REVERT, scope.memory.get(off, size))


def op_invalid(interp, scope):
    raise vmerrs.ErrInvalidOpcode


def op_undefined(interp, scope):
    raise vmerrs.ErrInvalidOpcode


def op_selfdestruct(interp, scope):
    evm = interp.evm
    beneficiary = scope.stack.pop().to_bytes(32, "big")[12:]
    balance = evm.statedb.get_balance(scope.contract.address)
    evm.statedb.add_balance(beneficiary, balance)
    evm.statedb.suicide(scope.contract.address)
    return (SIG_STOP, b"")


# --- jump table construction ---------------------------------------------


def _istanbul_table() -> Dict[int, Operation]:
    jt: Dict[int, Operation] = {
        OP.STOP: Operation(op_stop, 0, **_op(0, 0)),
        OP.ADD: Operation(op_add, G.GAS_FASTEST, **_op(2, 1)),
        OP.MUL: Operation(op_mul, G.GAS_FAST, **_op(2, 1)),
        OP.SUB: Operation(op_sub, G.GAS_FASTEST, **_op(2, 1)),
        OP.DIV: Operation(op_div, G.GAS_FAST, **_op(2, 1)),
        OP.SDIV: Operation(op_sdiv, G.GAS_FAST, **_op(2, 1)),
        OP.MOD: Operation(op_mod, G.GAS_FAST, **_op(2, 1)),
        OP.SMOD: Operation(op_smod, G.GAS_FAST, **_op(2, 1)),
        OP.ADDMOD: Operation(op_addmod, G.GAS_MID, **_op(3, 1)),
        OP.MULMOD: Operation(op_mulmod, G.GAS_MID, **_op(3, 1)),
        OP.EXP: Operation(op_exp, 0, dynamic_gas=gas_exp, **_op(2, 1)),
        OP.SIGNEXTEND: Operation(op_signextend, G.GAS_FAST, **_op(2, 1)),
        OP.LT: Operation(op_lt, G.GAS_FASTEST, **_op(2, 1)),
        OP.GT: Operation(op_gt, G.GAS_FASTEST, **_op(2, 1)),
        OP.SLT: Operation(op_slt, G.GAS_FASTEST, **_op(2, 1)),
        OP.SGT: Operation(op_sgt, G.GAS_FASTEST, **_op(2, 1)),
        OP.EQ: Operation(op_eq, G.GAS_FASTEST, **_op(2, 1)),
        OP.ISZERO: Operation(op_iszero, G.GAS_FASTEST, **_op(1, 1)),
        OP.AND: Operation(op_and, G.GAS_FASTEST, **_op(2, 1)),
        OP.OR: Operation(op_or, G.GAS_FASTEST, **_op(2, 1)),
        OP.XOR: Operation(op_xor, G.GAS_FASTEST, **_op(2, 1)),
        OP.NOT: Operation(op_not, G.GAS_FASTEST, **_op(1, 1)),
        OP.BYTE: Operation(op_byte, G.GAS_FASTEST, **_op(2, 1)),
        OP.SHL: Operation(op_shl, G.GAS_FASTEST, **_op(2, 1)),
        OP.SHR: Operation(op_shr, G.GAS_FASTEST, **_op(2, 1)),
        OP.SAR: Operation(op_sar, G.GAS_FASTEST, **_op(2, 1)),
        OP.KECCAK256: Operation(
            op_keccak256, G.KECCAK256_GAS, dynamic_gas=gas_keccak256,
            memory_size=mem_keccak, **_op(2, 1)
        ),
        OP.ADDRESS: Operation(op_address, G.GAS_QUICK, **_op(0, 1)),
        OP.BALANCE: Operation(op_balance, G.BALANCE_GAS_EIP1884, **_op(1, 1)),
        OP.ORIGIN: Operation(op_origin, G.GAS_QUICK, **_op(0, 1)),
        OP.CALLER: Operation(op_caller, G.GAS_QUICK, **_op(0, 1)),
        OP.CALLVALUE: Operation(op_callvalue, G.GAS_QUICK, **_op(0, 1)),
        OP.CALLDATALOAD: Operation(op_calldataload, G.GAS_FASTEST, **_op(1, 1)),
        OP.CALLDATASIZE: Operation(op_calldatasize, G.GAS_QUICK, **_op(0, 1)),
        OP.CALLDATACOPY: Operation(
            op_calldatacopy, G.GAS_FASTEST, dynamic_gas=gas_calldatacopy,
            memory_size=mem_calldatacopy, **_op(3, 0)
        ),
        OP.CODESIZE: Operation(op_codesize, G.GAS_QUICK, **_op(0, 1)),
        OP.CODECOPY: Operation(
            op_codecopy, G.GAS_FASTEST, dynamic_gas=gas_calldatacopy,
            memory_size=mem_calldatacopy, **_op(3, 0)
        ),
        OP.GASPRICE: Operation(op_gasprice, G.GAS_QUICK, **_op(0, 1)),
        OP.EXTCODESIZE: Operation(op_extcodesize, G.EXTCODE_SIZE_GAS_EIP150, **_op(1, 1)),
        OP.EXTCODECOPY: Operation(
            op_extcodecopy, G.EXTCODE_COPY_BASE_EIP150, dynamic_gas=gas_extcodecopy_base,
            memory_size=mem_extcodecopy, **_op(4, 0)
        ),
        OP.RETURNDATASIZE: Operation(op_returndatasize, G.GAS_QUICK, **_op(0, 1)),
        OP.RETURNDATACOPY: Operation(
            op_returndatacopy, G.GAS_FASTEST, dynamic_gas=gas_calldatacopy,
            memory_size=mem_calldatacopy, **_op(3, 0)
        ),
        OP.EXTCODEHASH: Operation(op_extcodehash, G.EXTCODE_HASH_GAS_EIP1884, **_op(1, 1)),
        OP.BLOCKHASH: Operation(op_blockhash, G.BLOCKHASH_GAS, **_op(1, 1)),
        OP.COINBASE: Operation(op_coinbase, G.GAS_QUICK, **_op(0, 1)),
        OP.TIMESTAMP: Operation(op_timestamp, G.GAS_QUICK, **_op(0, 1)),
        OP.NUMBER: Operation(op_number, G.GAS_QUICK, **_op(0, 1)),
        OP.DIFFICULTY: Operation(op_difficulty, G.GAS_QUICK, **_op(0, 1)),
        OP.GASLIMIT: Operation(op_gaslimit, G.GAS_QUICK, **_op(0, 1)),
        OP.CHAINID: Operation(op_chainid, G.GAS_QUICK, **_op(0, 1)),
        OP.SELFBALANCE: Operation(op_selfbalance, G.GAS_FAST, **_op(0, 1)),
        OP.POP: Operation(op_pop, G.GAS_QUICK, **_op(1, 0)),
        OP.MLOAD: Operation(
            op_mload, G.GAS_FASTEST, dynamic_gas=gas_mem_only,
            memory_size=mem_mload, **_op(1, 1)
        ),
        OP.MSTORE: Operation(
            op_mstore, G.GAS_FASTEST, dynamic_gas=gas_mem_only,
            memory_size=mem_mload, **_op(2, 0)
        ),
        OP.MSTORE8: Operation(
            op_mstore8, G.GAS_FASTEST, dynamic_gas=gas_mem_only,
            memory_size=mem_mstore8, **_op(2, 0)
        ),
        OP.SLOAD: Operation(op_sload, G.SLOAD_GAS_EIP2200, **_op(1, 1)),
        OP.SSTORE: Operation(
            op_sstore, 0, dynamic_gas=gas_sstore_eip2200, writes=True, **_op(2, 0)
        ),
        OP.JUMP: Operation(op_jump, G.GAS_MID, **_op(1, 0)),
        OP.JUMPI: Operation(op_jumpi, G.GAS_SLOW, **_op(2, 0)),
        OP.PC: Operation(op_pc, G.GAS_QUICK, **_op(0, 1)),
        OP.MSIZE: Operation(op_msize, G.GAS_QUICK, **_op(0, 1)),
        OP.GAS: Operation(op_gas, G.GAS_QUICK, **_op(0, 1)),
        OP.JUMPDEST: Operation(op_jumpdest, 1, **_op(0, 0)),
        OP.CREATE: Operation(
            op_create, G.CREATE_GAS, dynamic_gas=gas_create,
            memory_size=mem_create, writes=True, **_op(3, 1)
        ),
        OP.CALL: Operation(
            op_call, G.CALL_GAS_EIP150, dynamic_gas=gas_call,
            memory_size=mem_call, **_op(7, 1)
        ),
        OP.CALLCODE: Operation(
            op_callcode, G.CALL_GAS_EIP150, dynamic_gas=gas_callcode,
            memory_size=mem_call, **_op(7, 1)
        ),
        OP.RETURN: Operation(
            op_return, 0, dynamic_gas=gas_mem_only, memory_size=mem_return, **_op(2, 0)
        ),
        OP.DELEGATECALL: Operation(
            op_delegatecall, G.CALL_GAS_EIP150, dynamic_gas=gas_delegate_or_static,
            memory_size=mem_delegatecall, **_op(6, 1)
        ),
        OP.CREATE2: Operation(
            op_create2, G.CREATE_GAS, dynamic_gas=gas_create2,
            memory_size=mem_create, writes=True, **_op(4, 1)
        ),
        OP.STATICCALL: Operation(
            op_staticcall, G.CALL_GAS_EIP150, dynamic_gas=gas_delegate_or_static,
            memory_size=mem_delegatecall, **_op(6, 1)
        ),
        OP.REVERT: Operation(
            op_revert, 0, dynamic_gas=gas_mem_only, memory_size=mem_return, **_op(2, 0)
        ),
        OP.INVALID: Operation(op_invalid, 0, **_op(0, 0)),
        OP.SELFDESTRUCT: Operation(
            op_selfdestruct, 0, dynamic_gas=gas_selfdestruct_eip150,
            writes=True, **_op(1, 0)
        ),
        # coreth multicoin ops, live until AP2 (jump_table.go:415,1042)
        OP.BALANCEMC: Operation(op_balance_multicoin, G.BALANCE_GAS_EIP1884, **_op(2, 1)),
        OP.CALLEX: Operation(
            op_call_expert, G.CALL_GAS_EIP150, dynamic_gas=gas_call_expert_ap1,
            memory_size=mem_callexpert, **_op(9, 1)
        ),
    }
    for i in range(32):
        jt[OP.PUSH1 + i] = Operation(make_push(i + 1), G.GAS_FASTEST, **_op(0, 1))
    for i in range(16):
        jt[OP.DUP1 + i] = Operation(make_dup(i + 1), G.GAS_FASTEST, **_op(i + 1, i + 2))
        jt[OP.SWAP1 + i] = Operation(make_swap(i + 1), G.GAS_FASTEST, **_op(i + 2, i + 2))
    for i in range(5):
        jt[OP.LOG0 + i] = Operation(
            make_log(i), 0, dynamic_gas=make_gas_log(i),
            memory_size=mem_log, writes=True, **_op(i + 2, 0)
        )
    return jt


def _enable_ap1(jt) -> None:
    jt[OP.SSTORE].dynamic_gas = gas_sstore_ap1
    jt[OP.SELFDESTRUCT].dynamic_gas = gas_selfdestruct_ap1
    jt[OP.CALLEX].dynamic_gas = gas_call_expert_ap1


def _enable_2929(jt) -> None:
    jt[OP.SSTORE].dynamic_gas = gas_sstore_eip2929
    jt[OP.SLOAD].constant_gas = 0
    jt[OP.SLOAD].dynamic_gas = gas_sload_eip2929
    jt[OP.EXTCODECOPY].constant_gas = G.WARM_STORAGE_READ_COST
    jt[OP.EXTCODECOPY].dynamic_gas = gas_extcodecopy_eip2929
    for opc in (OP.EXTCODESIZE, OP.EXTCODEHASH, OP.BALANCE):
        jt[opc].constant_gas = G.WARM_STORAGE_READ_COST
        jt[opc].dynamic_gas = gas_account_check_eip2929
    jt[OP.CALL].constant_gas = G.WARM_STORAGE_READ_COST
    jt[OP.CALL].dynamic_gas = make_call_variant_eip2929(gas_call)
    jt[OP.CALLCODE].constant_gas = G.WARM_STORAGE_READ_COST
    jt[OP.CALLCODE].dynamic_gas = make_call_variant_eip2929(gas_callcode)
    jt[OP.STATICCALL].constant_gas = G.WARM_STORAGE_READ_COST
    jt[OP.STATICCALL].dynamic_gas = make_call_variant_eip2929(gas_delegate_or_static)
    jt[OP.DELEGATECALL].constant_gas = G.WARM_STORAGE_READ_COST
    jt[OP.DELEGATECALL].dynamic_gas = make_call_variant_eip2929(gas_delegate_or_static)
    jt[OP.SELFDESTRUCT].constant_gas = G.SELFDESTRUCT_GAS_EIP150
    jt[OP.SELFDESTRUCT].dynamic_gas = gas_selfdestruct_eip2929


def _enable_ap2(jt) -> None:
    jt[OP.BALANCEMC] = Operation(op_undefined, 0, **_op(0, 0))
    jt[OP.CALLEX] = Operation(op_undefined, 0, **_op(0, 0))


def _enable_3198(jt) -> None:
    jt[OP.BASEFEE] = Operation(op_basefee, G.GAS_QUICK, **_op(0, 1))


def _enable_3855(jt) -> None:
    jt[OP.PUSH0] = Operation(op_push0, G.GAS_QUICK, **_op(0, 1))


def _enable_3860(jt) -> None:
    jt[OP.CREATE].dynamic_gas = gas_create_eip3860
    jt[OP.CREATE2].dynamic_gas = gas_create2_eip3860


_table_cache: Dict[Tuple[bool, ...], Dict[int, Operation]] = {}


def jump_table_for_rules(rules) -> Dict[int, Operation]:
    """Per-fork instruction set (jump_table.go:92-137 lattice)."""
    key = (
        rules.is_apricot_phase1, rules.is_apricot_phase2,
        rules.is_apricot_phase3, rules.is_d_upgrade,
    )
    cached = _table_cache.get(key)
    if cached is not None:
        return cached
    jt = _istanbul_table()
    if rules.is_apricot_phase1:
        _enable_ap1(jt)
    if rules.is_apricot_phase2:
        _enable_2929(jt)
        _enable_ap2(jt)
    if rules.is_apricot_phase3:
        _enable_3198(jt)
    if rules.is_d_upgrade:
        _enable_3855(jt)
        _enable_3860(jt)
    _table_cache[key] = jt
    return jt


# --- fast dispatch: list jump table + pre-parsed instruction streams ------
#
# The per-step costs the legacy loop pays on EVERY opcode — dict lookup,
# five attribute loads off the Operation dataclass, a closure call just to
# read PUSH immediates out of the bytecode — are all decidable at parse
# time. A FastTable holds the fork's 256-entry operation list and a cache
# (keyed by code_hash, like _analysis_cache) of instruction streams: one
# flat tuple per byte position with the Operation fields folded in, PUSH
# immediates decoded once, and the next pc precomputed (so PUSH data is
# skipped without a closure call).


class FastTable:
    __slots__ = ("ops", "streams")

    def __init__(self, ops: List[Optional[Operation]]):
        self.ops = ops
        self.streams: Dict[bytes, list] = {}


_fast_table_cache: Dict[Tuple[bool, ...], FastTable] = {}


def fast_table_for_rules(rules) -> FastTable:
    key = (
        rules.is_apricot_phase1, rules.is_apricot_phase2,
        rules.is_apricot_phase3, rules.is_d_upgrade,
    )
    ft = _fast_table_cache.get(key)
    if ft is None:
        jt = jump_table_for_rules(rules)
        ft = FastTable([jt.get(i) for i in range(256)])
        _fast_table_cache[key] = ft
    return ft


def _make_pc_push(v: int) -> ExecFn:
    # PC is a constant per instruction site: pushing the baked-in value
    # frees the fast loop from syncing interp.pc before every execute
    def fn(interp, scope):
        scope.stack.push(v)

    return fn


def build_stream(code: bytes, ops: List[Optional[Operation]]) -> list:
    """Instruction stream: stream[pc] is (op, execute, constant_gas,
    min_stack, max_stack, dynamic_gas, memory_size, writes, push_value,
    next_pc), or None for opcodes outside the fork's table. Entry [len]
    is the virtual trailing STOP (running off the end halts)."""
    n = len(code)
    stream: list = [None] * (n + 1)
    stop = ops[OP.STOP]
    stream[n] = (
        OP.STOP, stop.execute, stop.constant_gas, stop.min_stack,
        stop.max_stack, stop.dynamic_gas, stop.memory_size, stop.writes,
        None, n,
    )
    for i in range(n):
        opb = code[i]
        operation = ops[opb]
        if operation is None:
            continue  # invalid opcode: the loop raises without tracing
        ex = operation.execute
        pushv = None
        nxt = i + 1
        if OP.PUSH1 <= opb <= OP.PUSH32:
            size = opb - OP.PUSH1 + 2
            chunk = code[i + 1 : i + size]
            if len(chunk) < size - 1:
                chunk = chunk.ljust(size - 1, b"\x00")
            pushv = int.from_bytes(chunk, "big")
            nxt = min(i + size, n)
            ex = None
        elif ex is op_push0:
            pushv = 0
            ex = None
        elif ex is op_pc:
            ex = _make_pc_push(i)
        stream[i] = (
            opb, ex, operation.constant_gas, operation.min_stack,
            operation.max_stack, operation.dynamic_gas,
            operation.memory_size, operation.writes, pushv, nxt,
        )
    return stream


def _opclass_table() -> List[str]:
    """256-entry opcode → class map for the sampled execution profile."""
    cls = ["other"] * 256
    spans = (
        (0x00, 0x00, "control"), (0x01, 0x0B, "arith"),
        (0x10, 0x1D, "bitlogic"), (0x20, 0x20, "keccak"),
        (0x30, 0x3F, "env"), (0x40, 0x48, "block"),
        (0x50, 0x50, "stack"), (0x51, 0x53, "memory"),
        (0x54, 0x55, "storage"), (0x56, 0x58, "control"),
        (0x59, 0x59, "memory"), (0x5A, 0x5A, "env"),
        (0x5B, 0x5B, "control"), (0x5F, 0x7F, "push"),
        (0x80, 0x8F, "dup"), (0x90, 0x9F, "swap"),
        (0xA0, 0xA4, "log"), (0xF0, 0xF2, "call"),
        (0xF3, 0xF3, "control"), (0xF4, 0xF5, "call"),
        (0xFA, 0xFA, "call"), (0xFD, 0xFF, "control"),
    )
    for lo, hi, name in spans:
        for o in range(lo, hi + 1):
            cls[o] = name
    return cls


_OPCLASS = _opclass_table()

# sample one step in every 2^_OPCLASS_SHIFT in the fast loop: cheap enough
# to stay always-on, dense enough that a block's profile is representative
_OPCLASS_SHIFT = 5
_OPCLASS_MASK = (1 << _OPCLASS_SHIFT) - 1


# --- run loop -------------------------------------------------------------


class Interpreter:
    """One interpreter per EVM, re-entered for nested frames
    (interpreter.go:126-295)."""

    def __init__(self, evm):
        self.evm = evm
        self.read_only = False
        self.return_data = b""
        self.pc = 0
        self.fast = fastloop_enabled(getattr(evm.config, "fastloop", None))

    def run(self, contract: Contract, input_: bytes, read_only: bool) -> bytes:
        """Execute the contract; raises vmerrs.VMError on failure. A raised
        ErrExecutionReverted carries .revert_data with the reason bytes."""
        evm = self.evm
        # Cooperative RPC deadline checkpoint at frame entry only: gas
        # bounds one frame, the frame boundary bounds a call tree. The
        # step loops below stay clock-free (SA003 # hot-path).
        deadline_check()
        # restore-on-exit frame state (the Go version allocates a fresh
        # interpreter frame; we reuse one object and save/restore)
        saved = (self.read_only, self.return_data, self.pc)
        if read_only and not self.read_only:
            self.read_only = True
        self.return_data = b""
        self.pc = 0
        try:
            return self._run(contract, input_)
        finally:
            self.read_only, self.return_data, self.pc = saved

    def _run(self, contract: Contract, input_: bytes) -> bytes:
        if self.fast:
            return self._run_fast(contract, input_)
        return self._run_legacy(contract, input_)

    def _run_legacy(self, contract: Contract, input_: bytes) -> bytes:
        if not contract.code:
            return b""
        contract.input = input_
        jt = self.evm.jump_table
        stack = Stack()
        mem = Memory()
        scope = Scope(stack, mem, contract)
        code = contract.code
        code_len = len(code)
        tracer = self.evm.config.tracer

        while True:
            pc = self.pc
            op = code[pc] if pc < code_len else OP.STOP
            operation = jt.get(op)
            if operation is None:
                raise vmerrs.ErrInvalidOpcode
            slen = len(stack.data)
            if slen < operation.min_stack:
                raise vmerrs.ErrStackUnderflow
            if slen > operation.max_stack:
                raise vmerrs.ErrStackOverflow
            if self.read_only and operation.writes:
                raise vmerrs.ErrWriteProtection
            cost = operation.constant_gas
            if not contract.use_gas(cost):
                raise vmerrs.ErrOutOfGas
            if operation.memory_size is not None:
                msize = operation.memory_size(stack)
                msize = ((msize + 31) // 32) * 32
            else:
                msize = 0
            if operation.dynamic_gas is not None:
                dyn = operation.dynamic_gas(self, contract, stack, mem, msize)
                if not contract.use_gas(dyn):
                    raise vmerrs.ErrOutOfGas
                if msize > 0:
                    new_words = msize // 32
                    total = G.MEMORY_GAS * new_words + new_words * new_words // G.QUAD_COEFF_DIV
                    if total > mem.last_gas_cost:
                        mem.last_gas_cost = total
                    mem.resize(msize)
            if tracer is not None:
                tracer.capture_state(pc, op, contract.gas + cost, cost, scope, self.return_data, self.evm.depth)

            result = operation.execute(self, scope)
            if result is None:
                self.pc += 1  # PUSH executes advance pc past their data
                continue
            if result is SIG_JUMPED:
                continue
            signal, data = result
            if signal is SIG_STOP:
                return b""
            if signal is SIG_RETURN:
                return data
            raise vmerrs.RevertError(data)  # SIG_REVERT

    def _run_fast(self, contract: Contract, input_: bytes) -> bytes:  # hot-path
        """The list-dispatch loop: same step semantics as _run_legacy —
        identical gas, refunds, tracer callbacks, and revert data — with
        the per-step table lookups folded into a pre-parsed instruction
        stream (see build_stream)."""
        code = contract.code
        if not code:
            return b""
        contract.input = input_
        ft = self.evm.fast_table
        key = contract.code_hash
        stream = ft.streams.get(key) if key is not None else None
        if stream is None:
            stream = build_stream(code, ft.ops)
            if key is not None and len(ft.streams) < 4096:
                ft.streams[key] = stream
        stack = Stack()
        mem = Memory()
        scope = Scope(stack, mem, contract)
        tracer = self.evm.config.tracer
        read_only = self.read_only
        use_gas = contract.use_gas
        sdata = stack.data
        push = stack.push
        n = len(code)
        stop_entry = stream[n]
        i = 0
        steps = 0
        classes: Dict[str, int] = {}
        opclass = _OPCLASS
        try:
            while True:
                e = stream[i] if i <= n else stop_entry
                if e is None:
                    raise vmerrs.ErrInvalidOpcode
                (opb, ex, cgas, min_st, max_st, dyn, memsz, writes,
                 pushv, nxt) = e
                if not (steps & _OPCLASS_MASK):
                    c = opclass[opb]
                    classes[c] = classes.get(c, 0) + 1
                steps += 1
                slen = len(sdata)
                if slen < min_st:
                    raise vmerrs.ErrStackUnderflow
                if slen > max_st:
                    raise vmerrs.ErrStackOverflow
                if read_only and writes:
                    raise vmerrs.ErrWriteProtection
                if not use_gas(cgas):
                    raise vmerrs.ErrOutOfGas
                if memsz is not None:
                    msize = memsz(stack)
                    msize = ((msize + 31) // 32) * 32
                else:
                    msize = 0
                if dyn is not None:
                    dgas = dyn(self, contract, stack, mem, msize)
                    if not use_gas(dgas):
                        raise vmerrs.ErrOutOfGas
                    if msize > 0:
                        new_words = msize // 32
                        total = (G.MEMORY_GAS * new_words
                                 + new_words * new_words // G.QUAD_COEFF_DIV)
                        if total > mem.last_gas_cost:
                            mem.last_gas_cost = total
                        mem.resize(msize)
                if tracer is not None:
                    tracer.capture_state(i, opb, contract.gas + cgas, cgas,
                                         scope, self.return_data,
                                         self.evm.depth)
                if pushv is not None:
                    # pre-decoded PUSH immediate (also PUSH0): no execute
                    push(pushv)
                    i = nxt
                    continue
                result = ex(self, scope)
                if result is None:
                    i = nxt
                    continue
                if result is SIG_JUMPED:
                    i = self.pc  # op_jump/op_jumpi validated + set the dest
                    continue
                signal, data = result
                if signal is SIG_STOP:
                    return b""
                if signal is SIG_RETURN:
                    return data
                raise vmerrs.RevertError(data)  # SIG_REVERT
        finally:
            if classes:
                # lazy: the interpreter runs inside forked shard workers,
                # where a module-scope metrics import would alias the
                # parent's registry (SA011); opclass attribution is a
                # parent-only tracing feature
                from ..metrics import default_registry as reg
                for c, cnt in classes.items():
                    reg.counter("chain/opclass/" + c).inc(cnt)
