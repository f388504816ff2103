"""Pluggable stateful-precompile framework; counterpart of
coreth_tpu/precompile/__init__.py.

A config carries WHERE the precompile lives (address) and WHEN it
activates (timestamp; None = never, 0 = genesis). `check_configure` runs
exactly once, on the first block whose timestamp crosses the activation
boundary: it marks the address non-empty (nonce 1, code 0x01, so Solidity
extcodesize checks pass) and lets the config seed its own state.
Contracts dispatch on 4-byte function selectors with an optional fallback.

The one registration is the batch keccak precompile (tpu_keccak.py).
Contracts follow the EVM's precompile calling convention
(evm/precompiles.Precompile: run(evm, caller, addr, input, gas, read_only)
-> (ret, remaining_gas), raising vmerrs on failure), and ChainConfig.rules
merges the active ones into the EVM's precompile set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

from .. import vmerrs
from ..crypto import keccak256
from ..evm.precompiles import Precompile

SELECTOR_LEN = 4


def function_selector(signature: str) -> bytes:
    """keccak256(signature)[:4] (contract.go CalculateFunctionSelector)."""
    if "(" not in signature or not signature.endswith(")"):
        raise ValueError(f"invalid function signature {signature!r}")
    return keccak256(signature.encode())[:SELECTOR_LEN]


def is_fork_transition(fork: Optional[int], parent_ts: Optional[int],
                       current_ts: int) -> bool:
    """utils.IsForkTransition: the fork activates within (parent, current].
    parent_ts None means genesis (nothing was active before), so any fork
    <= current activates now."""
    if fork is None:
        return False
    parent_active = parent_ts is not None and fork <= parent_ts
    current_active = fork <= current_ts
    return current_active and not parent_active


@dataclass(frozen=True)
class PrecompileConfig:
    """WHERE + WHEN for one stateful precompile
    (stateful_precompile_config.go:13-34). Subclasses override
    `contract()` (required) and `configure()` (optional state seeding,
    deterministic)."""

    address: bytes = b"\x00" * 20
    timestamp: Optional[int] = None  # None: never; 0: genesis; n: first ts>=n

    def is_activated(self, block_timestamp: int) -> bool:
        return self.timestamp is not None and self.timestamp <= block_timestamp

    def configure(self, chain_config, statedb, block_header) -> None:
        """State seeding on activation; default none."""

    def contract(self) -> Precompile:
        raise NotImplementedError


def check_configure(chain_config, parent_ts: Optional[int], block_header,
                    config: PrecompileConfig, statedb) -> None:
    """Activate [config] if the parent->block transition crosses its
    timestamp (stateful_precompile_config.go:44-56): mark the address
    non-empty as contract creation does, then let the config seed its
    state."""
    if is_fork_transition(config.timestamp, parent_ts, block_header.time):
        statedb.set_nonce(config.address, 1)
        statedb.set_code(config.address, b"\x01")
        config.configure(chain_config, statedb, block_header)


@dataclass
class PrecompileFunction:
    """One selector-dispatched entry point (contract.go:71-87):
    execute(evm, caller, addr, packed_args, gas, read_only) ->
    (ret, remaining_gas), raising vmerrs on failure; packed_args excludes
    the 4-byte selector."""

    selector: bytes
    execute: Callable


class SelectorDispatchContract(Precompile):
    """StatefulPrecompiledContract via 4-byte selectors (contract.go
    :92-141). No input -> the fallback (if registered); a short or
    unknown selector -> a plain error (the EVM burns the remaining gas,
    as for a failed built-in)."""

    def __init__(self, functions: Sequence[PrecompileFunction],
                 fallback: Optional[Callable] = None):
        self._functions: Dict[bytes, PrecompileFunction] = {}
        for fn in functions:
            if len(fn.selector) != SELECTOR_LEN:
                raise ValueError(
                    f"selector must be 4 bytes, got {fn.selector!r}")
            if fn.selector in self._functions:
                raise ValueError(f"duplicate selector {fn.selector.hex()}")
            self._functions[fn.selector] = fn
        self._fallback = fallback

    def run(self, evm, caller, addr, input_: bytes, gas: int,
            read_only: bool) -> Tuple[bytes, int]:
        if len(input_) == 0 and self._fallback is not None:
            return self._fallback(evm, caller, addr, b"", gas, read_only)
        if len(input_) < SELECTOR_LEN:
            raise vmerrs.ErrPrecompileFailure
        fn = self._functions.get(input_[:SELECTOR_LEN])
        if fn is None:
            raise vmerrs.ErrPrecompileFailure
        return fn.execute(evm, caller, addr, input_[SELECTOR_LEN:], gas,
                          read_only)


def charge_gas(gas: int, cost: int) -> int:
    """Deduct or raise ErrOutOfGas (contract.go deductGas)."""
    if gas < cost:
        raise vmerrs.ErrOutOfGas
    return gas - cost


from .tpu_keccak import TPU_KECCAK_ADDR, TpuKeccakConfig  # noqa: E402

__all__ = [
    "PrecompileConfig", "PrecompileFunction", "SelectorDispatchContract",
    "check_configure", "is_fork_transition", "function_selector",
    "charge_gas", "TpuKeccakConfig", "TPU_KECCAK_ADDR", "SELECTOR_LEN",
]
